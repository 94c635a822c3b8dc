"""ObjectRef: a future handle to an object in the distributed store.

Reference analogue: ``ObjectRef`` (``python/ray/includes/object_ref.pxi``).
Dumb by design — it holds only the id; resolution goes through the
process-global client so refs can be pickled into task args, stored inside
other objects, and reconstructed in any process of the cluster.
"""

from __future__ import annotations

import threading

from .ids import ObjectID, TaskID

# Per-thread capture of refs pickled into a value. A worker storing a
# task return activates this around serialization so the node can pin
# the CONTAINED objects until the return object itself is freed —
# without it, a ref that only lives inside a not-yet-deserialized
# return loses its last holder the moment the producer's locals die
# (reference analogue: borrowed-ref tracking inside returned values,
# ``reference_count.h``).
_capture = threading.local()


def begin_ref_capture() -> None:
    _capture.ids = []


def end_ref_capture() -> list:
    ids = getattr(_capture, "ids", None)
    _capture.ids = None
    return ids or []


class ObjectRef:
    """Distributed reference counting (reference: ``reference_count.h:61``
    local references): every live ObjectRef instance counts toward its
    process's local count for the object; the process tells its node on
    the 0→1 and 1→0 transitions, and the control plane frees the object
    when no process holds a reference and no submitted task uses it.
    Unpickling a ref (task args, values containing refs) registers the
    receiving process as a borrower automatically."""

    __slots__ = ("id", "_tracked")

    def __init__(self, object_id: ObjectID, _track: bool = True):
        self.id = object_id
        self._tracked = False
        if _track:
            from . import context
            client = context.current_client
            if client is not None:
                client.ref_incr(object_id)
                self._tracked = True

    def __del__(self):
        if self._tracked:
            try:
                from . import context
                client = context.current_client
                if client is not None:
                    client.ref_decr(self.id)
            except Exception:   # interpreter teardown / closed conn
                pass

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def task_id(self) -> TaskID:
        """The task whose return this ref is. For ``put`` objects the result
        is a synthetic id that matches no submitted task (cancel is a no-op,
        as in the reference)."""
        return TaskID(TaskID.KIND + self.id.binary()[:15])

    def future(self):
        """A concurrent.futures.Future resolving to the object's value."""
        from . import context
        client = context.require_client()
        return client.as_future(self)

    def __await__(self):
        import asyncio
        from . import context
        client = context.require_client()
        return asyncio.wrap_future(client.as_future(self)).__await__()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __reduce__(self):
        ids = getattr(_capture, "ids", None)
        if ids is not None:
            ids.append(self.id)
        return (ObjectRef, (self.id,))


class ObjectRefGenerator:
    """Consumer handle for a streaming task's dynamic returns
    (reference: ``_raylet.pyx:252`` ObjectRefGenerator). Iterating
    yields ObjectRefs one by one as the producer reports them; the item
    request is what paces the producer's backpressure window. Raises the
    task's error at the index where production broke; StopIteration at
    the stream end."""

    def __init__(self, task_id: TaskID):
        self.task_id = task_id
        self._index = 0
        self._count = None          # known stream length once ended
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        from . import context
        from . import serialization as ser
        if self._count is not None and self._index >= self._count:
            raise StopIteration
        client = context.require_client()
        status, payload = client.gen_next(self.task_id, self._index)
        if status == "item":
            ref = ObjectRef(payload.object_id)
            self._index += 1
            return ref
        # terminal: tell the node so it drops the stream record (a
        # long-lived cluster must not accumulate one per stream)
        self._close()
        if status == "end":
            self._count = payload
            raise StopIteration
        # error ends the stream too: a retried next() must raise
        # StopIteration locally, not park on the dropped record
        self._count = self._index
        raise ser.from_bytes(payload)       # status == "error"

    def _close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                from . import context
                client = context.current_client
                if client is not None:
                    client.gen_close(self.task_id)
            except Exception:   # teardown / closed conn
                pass

    def __del__(self):
        self._close()

    def __reduce__(self):
        # passing a generator between processes would need cross-owner
        # consumed-index coordination; the reference restricts this too
        raise TypeError(
            "ObjectRefGenerator is not picklable; iterate it in the "
            "process that called .remote(), passing the yielded "
            "ObjectRefs on instead")
