"""Shared-memory object store (plasma-equivalent).

Equivalent role to the reference's plasma store
(``src/ray/object_manager/plasma/store.h:55`` — shm segments + allocator +
LRU eviction + spilling). Design differences, on purpose:

- Objects are immutable, one POSIX shm segment per large object
  (``multiprocessing.shared_memory``) instead of one dlmalloc arena — the
  kernel is our allocator; small objects are carried inline in RPC frames
  (reference analogue: in-memory store, ``memory_store.h:43``).
- Readers in any process attach by name for zero-copy access (pickle-5
  out-of-band buffers point straight into the mapping), standing in for
  plasma's fd-passing (``fling.cc``).
- When the store exceeds its budget, least-recently-used unpinned primary
  copies are spilled to disk files and restored on demand (reference
  analogue: ``local_object_manager.h:110`` + ``external_storage.py:246``).
"""

from __future__ import annotations

import glob
import itertools
import json
import mmap
import os
import pickle
import tempfile
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from multiprocessing import shared_memory, resource_tracker
from typing import Dict, List, Optional, Tuple

from . import fieldsan
from . import locksan
from . import serialization as ser
from .config import CONFIG
from .ids import ObjectID

# ray_tpu's prefix is "rtpu": the two runtimes share /dev/shm, and neither
# may reap the other's segments
_SHM_PREFIX = "rtpt"
_SHM_DIR = "/dev/shm"

# Secondary-copy (adopted) segments get a per-call unique suffix: two
# concurrent pulls of the same object in one process must not collide on
# a deterministic name (the second create would raise FileExistsError and
# fail the pull instead of deduping).
_adopt_seq = itertools.count()


def _adopt_segment_name(object_id: ObjectID) -> str:
    return (f"{_segment_name(object_id)}p{os.getpid() % 100000}"
            f"c{next(_adopt_seq)}")


def _mk_meta(t: tuple) -> "ObjectMeta":
    """Rebuild an ObjectMeta from its flattened wire tuple (see
    ``ObjectMeta.__reduce__``)."""
    m = ObjectMeta.__new__(ObjectMeta)
    (oid, m.size, m.inline, m.shm_name, m.error, m.node_hint,
     m.arena_ref, m.flags) = t
    m.object_id = ObjectID(oid)
    return m


def _proc_start_token(pid: int) -> Optional[str]:
    """Process identity token: the kernel start time (field 22 of
    ``/proc/<pid>/stat``, in jiffies). A (pid, starttime) pair uniquely
    names one process incarnation, so a recycled pid can't masquerade as
    a live manifest owner. None off-Linux (reaping degrades to never)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
        # comm (field 2) may contain spaces/parens; fields resume after
        # the LAST ')' — starttime is the 20th field from there
        return stat[stat.rindex(b")") + 2:].split()[19].decode()
    except (OSError, ValueError, IndexError):
        return None


def reap_orphan_shm(root: str = _SHM_DIR) -> int:
    """Unlink shm artifacts (arena file + segments) left by stores whose
    owner process died without ``shutdown()`` (SIGKILL, OOM-kill). Every
    store appends what it creates to a small manifest file in /dev/shm
    keyed by (pid, starttime); this scans all manifests, skips live
    owners, and removes everything a dead owner left behind — reference
    analogue: the raylet's plasma directory cleanup on restart. Called
    from every store __init__ (so the next node to start on the host
    collects the garbage) and from ``rtpu`` CLI paths. Returns the
    number of artifacts removed."""
    reaped = 0
    for mf in glob.glob(os.path.join(root, "rtpt_manifest_*")):
        try:
            with open(mf, "r") as f:
                lines = f.read().splitlines()
            hdr = json.loads(lines[0])
        except (OSError, ValueError, IndexError):
            continue
        pid = hdr.get("pid")
        if pid and _proc_start_token(pid) == hdr.get("start"):
            continue                      # owner incarnation still alive
        for name in [hdr.get("arena")] + lines[1:]:
            if not name:
                continue
            path = name if os.path.isabs(name) else os.path.join(root, name)
            try:
                os.unlink(path)
                reaped += 1
            except OSError:
                pass
        try:
            os.unlink(mf)
        except OSError:
            pass
    return reaped


def _segment_name(object_id: ObjectID) -> str:
    # Full 32-hex-char id: put ids carry only 8 random bytes (the rest is
    # owner entropy), so truncating here would leave too little entropy
    # and collide segment names at scale.
    return f"{_SHM_PREFIX}{object_id.hex()}"


def create_segment(object_id: ObjectID, size: int) -> shared_memory.SharedMemory:
    """Create a named segment from a non-authority process (worker/driver
    writing a large object directly). Unregistered from the resource tracker
    because lifetime is owned by the node store that adopts it."""
    seg = shared_memory.SharedMemory(
        create=True, size=max(size, 1), name=_segment_name(object_id))
    try:
        resource_tracker.unregister(seg._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:
        pass
    return seg


class _AttachedSegment(shared_memory.SharedMemory):
    """Reader-side attachment that leaves the resource tracker as it was.

    CPython 3.12's ``SharedMemory.__init__`` registers the name with the
    resource tracker on attach too, and ``unlink`` unregisters it. A reader
    whose registration outlives the segment (the node store unlinks it)
    gets "leaked shared_memory objects" and "No such file" warnings at
    exit. The tracker keeps a set of names, not counts, so an unregister
    after attaching would also drop the node store's own registration of a
    segment it created in the same process (the in-process driver). So the
    attachment sends the tracker nothing: ``__init__`` is the POSIX attach
    of ``SharedMemory`` without its ``register``, and ``unlink`` removes
    the name without an ``unregister``. Swallows the BufferError raised at
    interpreter exit when user code still holds zero-copy numpy views into
    the mapping (the OS reclaims it anyway)."""

    def __init__(self, name: str):
        if not shared_memory._USE_POSIX:  # type: ignore[attr-defined]
            super().__init__(name=name)
            return
        path = "/" + name if self._prepend_leading_slash else name
        self._fd = shared_memory._posixshmem.shm_open(  # type: ignore[attr-defined]
            path, os.O_RDWR, mode=self._mode)
        self._name = path
        try:
            size = os.fstat(self._fd).st_size
            self._mmap = mmap.mmap(self._fd, size)
        except OSError:
            os.close(self._fd)
            self._fd = -1
            raise
        self._size = size
        self._buf = memoryview(self._mmap)

    def unlink(self):
        if shared_memory._USE_POSIX and self._name:  # type: ignore[attr-defined]
            shared_memory._posixshmem.shm_unlink(self._name)  # type: ignore[attr-defined]
        else:
            super().unlink()

    def __del__(self):
        try:
            super().__del__()
        except BufferError:
            pass


def attach_segment(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment without touching the resource tracker
    (see `_AttachedSegment`); cleanup is owned by the node store."""
    return _AttachedSegment(name)


@dataclass
class ObjectMeta:
    """Where an object's value lives; travels in RPC messages."""

    # flag bits (``flags``):
    # LAZY — the primary's bytes still live in the owner process's heap,
    # promoted to shm on first cross-process demand (reference analogue:
    # CoreWorker in-memory store → plasma promotion). SPILLED — the
    # primary lives in a spill file on the owner's disk; directory rows
    # sharing this meta thereby advertise the spilled location
    # (restore-on-get clears it).
    LAZY = 1
    SPILLED = 2

    object_id: ObjectID
    size: int
    inline: Optional[bytes] = None  # wire-format bytes, for small objects
    shm_name: Optional[str] = None  # segment name, for large objects
    error: Optional[bytes] = None   # pickled exception, for failed tasks
    node_hint: Optional[bytes] = None  # NodeID binary of a known location
    # (arena_path, payload_offset): object lives in the node's C++ shm
    # arena (plasma-style Create/Seal; ``native/object_arena.cpp``)
    arena_ref: Optional[tuple] = None
    flags: int = 0

    def __reduce_ex__(self, protocol):
        # hot-path pickle: metas ride every TASK_DONE / GET_REPLY /
        # dispatch frame; flat tuple with the id as raw bytes is ~4x
        # cheaper than the default dataclass reduce (see
        # TaskSpec.__reduce__ for the measurement). Large inline
        # payloads wrap in a PickleBuffer so the transport ships them
        # out-of-band as iovecs (zero copy through the pickle stream);
        # a pickler with no buffer_callback keeps them in-band, so
        # non-transport picklings (GCS persistence) still work.
        inline = self.inline
        if inline is not None:
            if (protocol >= 5
                    and len(inline) >= CONFIG.transport_oob_threshold_bytes):
                inline = pickle.PickleBuffer(inline)
            elif not isinstance(inline, bytes):
                # normalize foreign buffer types: a meta re-forwarded
                # after an out-of-band decode carries a memoryview,
                # which plain pickle rejects
                inline = bytes(inline)
        return (_mk_meta, ((self.object_id.binary(), self.size,
                            inline, self.shm_name, self.error,
                            self.node_hint, self.arena_ref, self.flags),))

    def is_error(self) -> bool:
        return self.error is not None

    def has_value(self) -> bool:
        # a LAZY or SPILLED meta has a value — it just isn't mappable
        # right now (resolvable through the owner, like any remote
        # location)
        return (self.inline is not None or self.shm_name is not None
                or self.arena_ref is not None or self.error is not None
                or bool(self.flags & (ObjectMeta.LAZY
                                      | ObjectMeta.SPILLED)))


@dataclass
class _Entry:
    meta: ObjectMeta
    segment: Optional[shared_memory.SharedMemory] = None
    sealed: bool = False
    pinned: int = 0
    spilled_path: Optional[str] = None
    last_used: float = field(default_factory=time.monotonic)
    charged: bool = False  # whether meta.size is counted in store._used
    # meta has been handed to a reader: arena-backed entries then become
    # unspillable — a reader may hold zero-copy views into the arena, and
    # unlike POSIX segments (kernel refcount keeps pages alive) a freed
    # arena block gets reused, which would silently corrupt those views
    ever_read: bool = False
    # connection that holds an unsealed Create; its death reclaims it
    writer_tag: Optional[int] = None
    # lazy primary: (serialized_meta_bytes, out-of-band views) still in
    # this process's heap; promoted by _materialize_locked on demand
    lazy: Optional[tuple] = None


@fieldsan.guarded
class ObjectStore:
    """Node-local authority over object values.

    Thread-safe; used from the node service event loop and (for driver-side
    fast-path puts) the driver thread.
    """

    # arena-eligible payload range: below -> inline, above -> dedicated
    # segment (huge objects would fragment the arena). Class default;
    # scaled to capacity//4 per instance — the arena memcpy path is ~7x
    # faster than first-touch faulting a fresh POSIX segment.
    ARENA_MAX_OBJECT = 64 << 20

    def __init__(self, capacity_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        self._lock = locksan.rlock("store.entries")
        self._entries: "OrderedDict[ObjectID, _Entry]" = OrderedDict()
        self._capacity = (capacity_bytes
                          or CONFIG.object_store_shm_max_bytes
                          or CONFIG.object_store_memory_mb * (1 << 20))
        self.ARENA_MAX_OBJECT = max(64 << 20, self._capacity // 4)
        self._used = 0
        self._spill_dir = (spill_dir or CONFIG.object_store_spill_dir
                           or os.path.join(tempfile.gettempdir(),
                                           "rtpt_spill"))
        self.num_spilled = 0
        self.num_restored = 0
        self.num_lazy_puts = 0
        self.num_materialized = 0
        self.spilled_bytes_total = 0
        self.restored_bytes_total = 0
        # ("spill"|"restore", ObjectID, size) tuples appended under _lock
        # and drained by the node service, which emits the attributed
        # OBJECT_SPILLED/OBJECT_RESTORED events + byte counters OUTSIDE
        # the store lock (the store must not call into gcs/telemetry with
        # its lock held — lock-order hygiene)
        self._spill_events: List[tuple] = []
        # collect what crashed predecessors left in /dev/shm before we
        # add our own arena/segments to it
        reap_orphan_shm()
        # C++ shm arena (plasma-equivalent allocator). One mapping per
        # node; all readers attach once. Optional: pure-python segments
        # remain the fallback and the path for huge objects.
        self._arena = None
        # freed-while-read arena blocks: (release_at, offset). A reader's
        # zero-copy numpy views alias arena bytes with no kernel refcount
        # (unlike POSIX segments), so reuse is delayed by
        # CONFIG.arena_free_quarantine_s after an explicit free().
        self._quarantine: List[tuple] = []
        if CONFIG.use_native_arena:
            try:
                from . import native
                if native.available():
                    # random suffix: pid+id can repeat across store
                    # restarts in one process, and reader processes cache
                    # mappings by path
                    suffix = os.urandom(8).hex()
                    path = f"/dev/shm/rtpt_arena_{suffix}"
                    self._arena = native.Arena(path, self._capacity)
            except Exception:
                self._arena = None
        # crash manifest: everything this store parks in /dev/shm is
        # recorded here (header: owner identity + arena path; one line
        # per segment), so reap_orphan_shm() can clean up after a
        # SIGKILL'd node. Flushed per append — durability against
        # SIGKILL is the whole point.
        self._manifest_f = None
        self._manifest_path = None
        try:
            self._manifest_path = os.path.join(
                _SHM_DIR,
                f"rtpt_manifest_{os.getpid()}_{os.urandom(4).hex()}")
            self._manifest_f = open(self._manifest_path, "w")
            self._manifest_f.write(json.dumps({
                "pid": os.getpid(),
                "start": _proc_start_token(os.getpid()),
                "arena": self._arena.path if self._arena else None,
            }) + "\n")
            self._manifest_f.flush()
        except OSError:
            self._manifest_f = None
            self._manifest_path = None

    def _manifest_add(self, name: Optional[str]) -> None:
        """Record a segment this store owns in the crash manifest (the
        file object serializes concurrent appends; each append is one
        short write + flush)."""
        f = self._manifest_f
        if f is None or not name:
            return
        try:
            f.write(name + "\n")
            f.flush()
        except (OSError, ValueError):
            pass

    # ------------------------------------------------------------------ put
    def put_inline(self, object_id: ObjectID, data: bytes) -> ObjectMeta:
        if not isinstance(data, bytes):
            # a store-resident inline must own its bytes: a zero-copy
            # view into a transport frame buffer would pin the whole
            # (up to max-batch-sized) frame for the object's lifetime
            data = bytes(data)
        meta = ObjectMeta(object_id=object_id, size=len(data), inline=data)
        with self._lock:
            self._ensure_capacity(len(data))
            self._entries[object_id] = _Entry(meta=meta, sealed=True,
                                              charged=True)
            self._used += len(data)
        return meta

    def put_lazy(self, object_id: ObjectID, smeta: bytes,
                 views: List[memoryview], total: int) -> Optional[ObjectMeta]:
        """Zero-copy put for a SAME-PROCESS writer (the head driver): the
        serialized form — meta pickle + out-of-band views straight into
        the caller's buffers — is parked in-heap and the entry is sealed
        immediately; **no bytes are copied at put time**. Promotion to
        the arena/a segment (the one unavoidable copy) happens on first
        cross-process demand, restore-blocking spill pressure, or pull —
        and never happens for objects freed unread. Reference analogue:
        the CoreWorker's in-memory store, from which objects are promoted
        to plasma only when another process needs them.

        The views alias the caller's object storage, so a caller that
        mutates the source object before the first get can observe its
        own mutation (documented at ``object_store_lazy_put``).
        Returns None when a sealed copy already exists (duplicate put)."""
        meta = ObjectMeta(object_id=object_id, size=total,
                          flags=ObjectMeta.LAZY)
        with self._lock:
            if object_id in self._entries:
                return None
            self._ensure_capacity(total)
            self._entries[object_id] = _Entry(
                meta=meta, sealed=True, charged=True,
                lazy=(smeta, list(views)))
            self._used += total
            self.num_lazy_puts += 1
        return meta

    # concurrency: requires(store.entries)
    def _materialize_locked(self, e: _Entry) -> None:
        """Promote a lazy primary into shared memory (arena block when it
        fits, else an owned segment). Budget was charged at put_lazy time
        so only the physical home changes here."""
        smeta, views = e.lazy
        size = e.meta.size
        off = (self._arena.alloc(size)
               if (self._arena is not None
                   and size <= self.ARENA_MAX_OBJECT) else None)
        if off is not None:
            ser.write_to(self._arena.buffer(off, size), smeta, views)
            e.meta.arena_ref = (self._arena.path, off)
        else:
            seg = shared_memory.SharedMemory(
                create=True, size=max(size, 1),
                name=_segment_name(e.meta.object_id))
            self._manifest_add(seg.name)
            ser.write_to(seg.buf, smeta, views)
            e.segment = seg
            e.meta.shm_name = seg.name
        e.meta.flags &= ~ObjectMeta.LAZY
        e.lazy = None
        self.num_materialized += 1

    def create(self, object_id: ObjectID, size: int) -> memoryview:
        """Allocate a shm segment; caller fills it then calls seal()."""
        with self._lock:
            self._ensure_capacity(size)
            seg = shared_memory.SharedMemory(
                create=True, size=max(size, 1), name=_segment_name(object_id))
            self._manifest_add(seg.name)
            meta = ObjectMeta(object_id=object_id, size=size,
                              shm_name=seg.name)
            self._entries[object_id] = _Entry(meta=meta, segment=seg,
                                              charged=True)
            self._used += size
            return seg.buf[:size]

    def seal(self, object_id: ObjectID) -> ObjectMeta:
        with self._lock:
            entry = self._entries[object_id]
            entry.sealed = True
            entry.last_used = time.monotonic()
            return entry.meta

    def put_error(self, object_id: ObjectID, error: bytes) -> ObjectMeta:
        meta = ObjectMeta(object_id=object_id, size=len(error), error=error)
        with self._lock:
            self._entries[object_id] = _Entry(meta=meta, sealed=True)
        return meta

    def alloc_in_arena(self, object_id: ObjectID, size: int,
                       writer_tag: Optional[int] = None) -> Optional[tuple]:
        """Plasma-style Create: reserve arena space for a writer in
        another process. Returns (arena_path, offset) or None (no arena /
        full / out of the arena size class). The entry exists unsealed
        until the writer's seal (adopt) lands; ``writer_tag`` (the
        writer's connection key) lets ``reclaim_unsealed`` free the block
        if the writer dies before sealing."""
        if self._arena is None or size > self.ARENA_MAX_OBJECT:
            return None
        with self._lock:
            self._sweep_quarantine()
            if object_id in self._entries:
                return None
            self._ensure_capacity(size)
            off = self._arena.alloc(size)
            if off is None:
                return None
            meta = ObjectMeta(object_id=object_id, size=size,
                              arena_ref=(self._arena.path, off))
            self._entries[object_id] = _Entry(meta=meta, charged=True,
                                              writer_tag=writer_tag)
            self._used += size
            return (self._arena.path, off)

    # concurrency: requires(store.entries)
    def _release_unsealed_locked(self, object_id: ObjectID,
                                 e: "_Entry") -> None:
        """Pop an unsealed entry and free its allocation (callers hold
        ``_lock``). The single home for the uncharge/arena-free
        sequence, shared by dead-writer reclaim and stale-Create
        replacement."""
        self._entries.pop(object_id, None)
        if e.charged:
            self._used -= e.meta.size
        if (e.meta.arena_ref is not None and self._arena is not None
                and e.meta.arena_ref[0] == self._arena.path):
            self._arena.free(e.meta.arena_ref[1])

    def reclaim_unsealed(self, writer_tag: int) -> None:
        """Free arena Creates whose writer connection died pre-seal."""
        with self._lock:
            dead = [(oid, e) for oid, e in self._entries.items()
                    if not e.sealed and e.writer_tag == writer_tag]
            for oid, e in dead:
                self._release_unsealed_locked(oid, e)

    def abort_create(self, object_id: ObjectID) -> None:
        """Discard an unsealed Create whose writer failed mid-fill: pop
        the entry, uncharge the budget, and return its allocation (arena
        block or owned shm segment). Without this a failed fill leaves a
        permanently unsealed entry that ``reclaim_unsealed`` can never
        match (no writer_tag) while its bytes stay charged forever."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or e.sealed:
                return
            self._release_unsealed_locked(object_id, e)
            if e.segment is not None:
                try:
                    e.segment.close()
                except (OSError, BufferError):
                    pass        # an outstanding view keeps the mmap; the
                try:            # unlink below still drops the backing file
                    e.segment.unlink()
                except OSError:
                    pass

    def adopt(self, meta: ObjectMeta) -> bool:
        """Record an object whose segment was created by another process
        (a worker sealing a large task return). This is the main write path,
        so the store budget is enforced here. For arena-backed objects this
        is the Seal half of Create/Seal: the entry exists from
        ``alloc_in_arena`` and budget is already charged. Returns False
        when a sealed copy already exists (the caller still owns its
        segment and must clean it up)."""
        if meta.inline is not None and not isinstance(meta.inline, bytes):
            # inline metas in the oob band (>= transport_oob_threshold,
            # <= object_store_shm_threshold_bytes) decode as memoryviews into the
            # recv frame buffer; a store-resident copy must not pin that
            # whole frame (up to transport_max_batch_bytes) per object
            meta.inline = bytes(meta.inline)
        with self._lock:
            existing = self._entries.get(meta.object_id)
            if existing is not None:
                if not existing.sealed and meta.arena_ref is not None \
                        and existing.meta.arena_ref == meta.arena_ref:
                    existing.sealed = True
                    existing.writer_tag = None
                    existing.last_used = time.monotonic()
                    return True
                if not existing.sealed:
                    # a retried writer fell back to a different home
                    # (e.g. segment after its predecessor's orphaned
                    # Create): reclaim the stale allocation, adopt fresh
                    self._release_unsealed_locked(meta.object_id, existing)
                else:
                    return False
            # charge: segments/inline always; arena refs only when the
            # block lives in OUR arena (the ingest path of adopt_begin —
            # a foreign arena_ref is metadata about a remote node's copy)
            arena_owned = (meta.arena_ref is not None
                           and self._arena is not None
                           and meta.arena_ref[0] == self._arena.path)
            charged = bool(meta.shm_name or meta.inline) or arena_owned
            if charged:
                self._ensure_capacity(meta.size)
            if meta.shm_name:
                self._manifest_add(meta.shm_name)
            self._entries[meta.object_id] = _Entry(meta=meta, sealed=True,
                                                   charged=charged)
            self._used += meta.size if charged else 0
            return True

    # ------------------------------------------------------------------ get
    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(object_id)
            return e is not None and e.sealed

    # concurrency: requires(store.entries)
    def _touch(self, object_id: ObjectID) -> Optional[_Entry]:
        """Lookup + LRU touch + restore-if-spilled; callers hold _lock.
        Handing out a meta marks the entry read (see _Entry.ever_read)."""
        e = self._entries.get(object_id)
        if e is None or not e.sealed:
            return None
        e.last_used = time.monotonic()
        e.ever_read = True
        self._entries.move_to_end(object_id)
        if e.spilled_path is not None:
            self._restore(object_id, e)
        if e.lazy is not None:
            # the meta is about to leave this process: promote so it
            # names a mappable location
            self._materialize_locked(e)
        return e

    def get_meta(self, object_id: ObjectID) -> Optional[ObjectMeta]:
        with self._lock:
            e = self._touch(object_id)
            return e.meta if e is not None else None

    def pin(self, object_id: ObjectID) -> None:
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None:
                e.pinned += 1

    def pin_and_get(self, object_id: ObjectID) -> Optional[ObjectMeta]:
        """Atomically pin an object and return a live meta, restoring a
        spilled entry first. This is the dependency-resolution primitive:
        the pin keeps the segment mapped (spilling skips pinned entries)
        until the consuming task unpins — reference analogue: raylet
        ``PinObjectIDs`` before dispatch (``node_manager.proto:388``)."""
        with self._lock:
            e = self._touch(object_id)
            if e is None:
                return None
            e.pinned += 1
            return e.meta

    def unpin(self, object_id: ObjectID) -> None:
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None and e.pinned > 0:
                e.pinned -= 1

    # concurrency: requires(store.entries)
    def _free_arena_block(self, e: _Entry) -> None:
        """Release an owned arena block; quarantine it if any reader may
        still hold zero-copy views into it (ADVICE r1: unconditional free
        reused blocks under live readers → silent corruption)."""
        off = e.meta.arena_ref[1]
        if e.ever_read and CONFIG.arena_free_quarantine_s > 0:
            self._quarantine.append(
                (time.monotonic() + CONFIG.arena_free_quarantine_s, off))
        else:
            self._arena.free(off)

    # concurrency: requires(store.entries)
    def _sweep_quarantine(self) -> None:
        """Callers hold _lock. Deadlines are appended in monotonic order
        (constant delay), so sweeping the prefix is enough. A block whose
        mapper refcount is still nonzero when its window expires (a
        reader process legitimately holding a long-lived zero-copy view,
        tracked by ``ArenaReader.tracked_buffer``) is requeued for
        another window instead of freed under the reader — the fixed
        window alone only covers readers that map *promptly*."""
        now = time.monotonic()
        requeue = []
        while self._quarantine and self._quarantine[0][0] <= now:
            _, off = self._quarantine.pop(0)
            rc = self._arena.refcount(off)
            if rc is not None and rc > 0:
                requeue.append(
                    (now + max(CONFIG.arena_free_quarantine_s, 1.0), off))
                continue
            self._arena.free(off)
        self._quarantine.extend(requeue)

    def free(self, object_ids: List[ObjectID]) -> None:
        with self._lock:
            if self._arena is not None:
                self._sweep_quarantine()
            for oid in object_ids:
                e = self._entries.pop(oid, None)
                if e is None:
                    continue
                if e.charged:
                    self._used -= e.meta.size
                if e.meta.arena_ref is not None:
                    # only the owning arena frees; adopted copies of
                    # another node's arena object are metadata-only
                    if (self._arena is not None
                            and e.meta.arena_ref[0] == self._arena.path):
                        self._free_arena_block(e)
                elif e.segment is not None:
                    try:
                        e.segment.close()
                        e.segment.unlink()
                    except FileNotFoundError:
                        pass
                elif e.meta.shm_name:
                    # segment created by a worker/driver process and adopted
                    # here by name only — unlink it via a fresh attachment
                    try:
                        seg = attach_segment(e.meta.shm_name)
                        seg.close()
                        seg.unlink()
                    except FileNotFoundError:
                        pass
                if e.spilled_path:
                    try:
                        os.unlink(e.spilled_path)
                    except OSError:
                        pass

    # -------------------------------------------------- network transfer
    def read_payload(self, object_id: ObjectID
                     ) -> Optional[Tuple[ObjectMeta, Optional[bytes]]]:
        """Raw wire bytes of an object, for cross-host pull (reference:
        ``object_manager.h:117`` Push/Pull). Inline/error values travel
        in the meta itself (payload None)."""
        return self.read_payload_chunk(object_id, 0, 1 << 62)

    def read_payload_chunk(self, object_id: ObjectID, offset: int,
                           length: int
                           ) -> Optional[Tuple[ObjectMeta, Optional[bytes]]]:
        """One bounded slice of an object's wire bytes (reference:
        chunked Push/Pull, ``object_manager.h:117`` — multi-GB objects
        must never become one socket frame). The entry is pinned during
        the copy so a concurrent spill can't unmap it; inline/error
        values ride the meta. A SPILLED object is served straight from
        its spill file — restoring the whole object per chunk would
        spill/restore-thrash for the length of the stream."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or not e.sealed:
                return None
            e.last_used = time.monotonic()
            e.ever_read = True
            self._entries.move_to_end(object_id)
            if e.lazy is not None:
                self._materialize_locked(e)
            meta = e.meta
            if meta.inline is not None or meta.error is not None:
                return (meta, None)
            spilled = e.spilled_path
            if spilled is None:
                e.pinned += 1
        if spilled is not None:
            try:
                with open(spilled, "rb") as f:
                    f.seek(offset)
                    data = f.read(max(0, min(length, meta.size - offset)))
                return (meta, data)
            except OSError:
                # Either restored (file unlinked, entry now in memory) or
                # the spill file is genuinely gone. ONE bounded re-check
                # through the in-memory path — unbounded retries would
                # recurse forever on a deleted spill file.
                with self._lock:
                    e = self._entries.get(object_id)
                    if (e is None or not e.sealed
                            or e.spilled_path is not None):
                        return None       # still spilled & unreadable
                    e.pinned += 1
                # fall through to the in-memory read below
        try:
            end = min(offset + length, meta.size)
            if offset >= meta.size:
                return (meta, b"")
            meta = e.meta   # may have been rewritten by a restore
            if (meta.arena_ref is not None and self._arena is not None
                    and meta.arena_ref[0] == self._arena.path):
                buf = self._arena.buffer(meta.arena_ref[1], meta.size)
                data = bytes(buf[offset:end])
            elif meta.shm_name is not None:
                seg = e.segment
                if seg is None:
                    # cache the attachment: a streamed pull reads many
                    # chunks, and re-mmapping the segment per chunk is
                    # pure overhead (freed with the entry)
                    seg = attach_segment(meta.shm_name)
                    with self._lock:
                        if e.segment is None:
                            e.segment = seg
                        elif seg is not e.segment:
                            seg.close()
                            seg = e.segment
                data = bytes(seg.buf[offset:end])
            else:
                return None
            return (meta, data)
        finally:
            self.unpin(object_id)

    def adopt_begin(self, object_id: ObjectID, size: int) -> "_AdoptWriter":
        """Incremental adoption of a pulled copy: allocate the backing
        store up front, stream chunks in, then finish() seals it as a
        local secondary copy.

        Prefers a RAW arena block so the OOB frames land with one
        mmap write (recv buffer → arena; no private-segment intermediate
        and no extra first-touch faulting). The block is deliberately NOT
        registered as an entry until finish(): an unsealed entry would
        let a concurrent adopt() of the same id (e.g. a local
        reconstruction finishing mid-pull) treat it as an abandoned
        writer and free the block the streaming writer is still copying
        into — finish() adopts (charging the budget then) or frees the
        block on a lost race. Falls back to a private segment when the
        arena is absent/full/out of size class."""
        off = None
        if self._arena is not None and size <= self.ARENA_MAX_OBJECT:
            with self._lock:
                self._sweep_quarantine()
                self._ensure_capacity(size)
                off = self._arena.alloc(size)
        if off is not None:
            return _AdoptWriter(self, object_id, size, arena_off=off)
        seg = shared_memory.SharedMemory(
            create=True, size=max(size, 1),
            name=_adopt_segment_name(object_id))
        self._manifest_add(seg.name)
        return _AdoptWriter(self, object_id, size, segment=seg)

    def adopt_payload(self, object_id: ObjectID, data: bytes) -> ObjectMeta:
        """Store a pulled copy of a remote object as a local secondary
        copy (never published to the directory — the primary stays with
        the owner). Only used cross-host, so the deterministic segment
        name cannot collide with the owner's."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None and e.sealed:
                return e.meta
        size = len(data)
        ref = self.alloc_in_arena(object_id, size)
        if ref is not None:
            self._arena.buffer(ref[1], size)[:] = data
            meta = ObjectMeta(object_id=object_id, size=size, arena_ref=ref)
        else:
            # distinct name: never collides with the owner's segment when
            # "cross-host" is simulated on one machine (RTPU_NODE_HOST)
            seg = shared_memory.SharedMemory(
                create=True, size=max(size, 1),
                name=_adopt_segment_name(object_id))
            seg.buf[:size] = data
            name = seg.name
            seg.close()
            meta = ObjectMeta(object_id=object_id, size=size, shm_name=name)
        if not self.adopt(meta):
            # A concurrent pull sealed a copy first: ours is redundant
            # and must not leak (unique names mean this race no longer
            # errors out). Arena case: our unsealed Create was already
            # reclaimed by the winner's adopt (_release_unsealed_locked),
            # so freeing again here would double-free — only the private
            # shm segment is still ours to unlink.
            if meta.arena_ref is None:
                try:
                    s = shared_memory.SharedMemory(name=meta.shm_name)
                    s.close()
                    s.unlink()
                except OSError:
                    pass
            with self._lock:
                e = self._entries.get(object_id)
                if e is not None and e.sealed:
                    return e.meta
            # winner evicted between adopt() and the re-lookup: our copy
            # is gone too (unlinked/reclaimed above) — redo the adoption
            # from the payload we still hold
            return self.adopt_payload(object_id, data)
        return meta

    def create_local(self, object_id: ObjectID, size: int
                     ) -> Tuple[memoryview, ObjectMeta]:
        """Writable destination for a SAME-PROCESS writer (the head
        driver): an arena block when possible, else an owned segment.
        The caller fills the view, then calls ``seal(object_id)`` —
        no ALLOC/PUT round trips (reference analogue: the CoreWorker's
        local plasma client)."""
        ref = self.alloc_in_arena(object_id, size)
        if ref is not None:
            with self._lock:
                meta = self._entries[object_id].meta
            return self._arena.buffer(ref[1], size)[:size], meta
        buf = self.create(object_id, size)
        with self._lock:
            meta = self._entries[object_id].meta
        return buf, meta

    def put_payload(self, object_id: ObjectID, data) -> ObjectMeta:
        """Materialize wire bytes as the local PRIMARY copy, landing
        them directly in an arena block when possible. ``data`` may be
        a zero-copy memoryview into a transport frame buffer (pickle-5
        out-of-band), so this is the payload's only copy after it left
        the socket. Used for cross-host driver puts (PUT_OBJECT_WIRE)."""
        size = len(data)
        ref = self.alloc_in_arena(object_id, size)
        if ref is not None:
            self._arena.buffer(ref[1], size)[:] = data
            meta = ObjectMeta(object_id=object_id, size=size,
                              arena_ref=ref)
            self.adopt(meta)            # the Seal half of Create/Seal
            return meta
        seg = create_segment(object_id, size)
        try:
            seg.buf[:size] = data
            name = seg.name
        finally:
            seg.close()
        meta = ObjectMeta(object_id=object_id, size=size, shm_name=name)
        if not self.adopt(meta):
            # a sealed copy already exists (duplicate put): ours is
            # redundant and must not leak the segment
            try:
                s = shared_memory.SharedMemory(name=name)
                s.close()
                s.unlink()
            except OSError:
                pass
            existing = self.get_meta(object_id)
            if existing is not None:
                return existing
        return meta

    def objects_snapshot(self) -> Dict[ObjectID, tuple]:
        """Per-object introspection view: ``oid -> (pinned_count,
        spilled)`` for every sealed entry. Feeds the PINNED_IN_STORE /
        spilled columns of ``state.list_objects()`` (pin counts are
        node-local store facts the control-plane ledger can't know)."""
        with self._lock:
            return {oid: (e.pinned, e.spilled_path is not None)
                    for oid, e in self._entries.items() if e.sealed}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = {
                "num_objects": len(self._entries),
                "used_bytes": self._used,
                "capacity_bytes": self._capacity,
                "num_spilled": self.num_spilled,
                "num_restored": self.num_restored,
                "spilled_bytes_total": self.spilled_bytes_total,
                "restored_bytes_total": self.restored_bytes_total,
                "num_lazy_puts": self.num_lazy_puts,
                "num_materialized": self.num_materialized,
                "arena_enabled": int(self._arena is not None),
            }
            shm_bytes = 0
            for e in self._entries.values():
                m = e.meta
                if m.shm_name is not None or (
                        m.arena_ref is not None and self._arena is not None
                        and m.arena_ref[0] == self._arena.path):
                    shm_bytes += m.size
            out["shm_bytes"] = shm_bytes
            if self._arena is not None:
                out["arena_used_bytes"] = self._arena.used
                out["arena_capacity_bytes"] = self._arena.capacity
                out["arena_num_blocks"] = self._arena.num_blocks
                out["arena_quarantined_blocks"] = len(self._quarantine)
            return out

    def drain_spill_events(self) -> List[tuple]:
        """Hand the accumulated ("spill"|"restore", oid, size) records to
        the node service, which emits the attributed cluster events and
        byte counters outside the store lock."""
        with self._lock:
            if not self._spill_events:
                return []
            out, self._spill_events = self._spill_events, []
            return out

    # ------------------------------------------------------- spill/restore
    # concurrency: requires(store.entries)
    def _ensure_capacity(self, incoming: int) -> None:
        threshold = CONFIG.object_store_spill_threshold * self._capacity
        if self._used + incoming <= threshold:
            return
        for oid in list(self._entries):
            if self._used + incoming <= threshold:
                break
            e = self._entries[oid]
            if not (e.sealed and e.pinned == 0 and e.spilled_path is None
                    and e.charged):
                continue
            if e.lazy is not None or e.meta.shm_name is not None:
                self._spill(oid, e)
            elif e.meta.arena_ref is not None:
                # a READ arena entry may have live zero-copy views into
                # its block; spill it only when the cross-process mapper
                # refcount proves it idle (the block still rides the free
                # quarantine so a reader holding just the meta reads the
                # intact bytes until the window drains). No refcount API
                # (older .so) → stay conservative: unread entries only.
                rc = (self._arena.refcount(e.meta.arena_ref[1])
                      if (self._arena is not None
                          and e.meta.arena_ref[0] == self._arena.path)
                      else None)
                if not e.ever_read or rc == 0:
                    self._spill(oid, e)

    # concurrency: requires(store.entries)
    def _spill(self, object_id: ObjectID, e: _Entry) -> None:
        os.makedirs(self._spill_dir, exist_ok=True)
        path = os.path.join(self._spill_dir, _segment_name(object_id))
        if e.lazy is not None:
            # lazy primary under pressure: serialize straight to disk —
            # the value never transits shm at all (put → disk, one copy)
            smeta, views = e.lazy
            with open(path, "wb") as f:
                ser.write_file(f, smeta, views)
            e.lazy = None
            e.meta.flags &= ~ObjectMeta.LAZY
        elif e.meta.arena_ref is not None:
            if (self._arena is None
                    or e.meta.arena_ref[0] != self._arena.path):
                return
            off = e.meta.arena_ref[1]
            with open(path, "wb") as f:
                f.write(self._arena.buffer(off, e.meta.size))
            # quarantined, not freed, when the entry was ever read: a
            # reader still holding the meta keeps reading the intact old
            # bytes until the window (and its mapper refcount) drains,
            # after which its incref fails cleanly and it re-GETs
            self._free_arena_block(e)
            e.meta.arena_ref = None
        else:
            seg = e.segment
            if seg is None:
                # adopted segment: created by a worker/driver, attach by name
                try:
                    seg = attach_segment(e.meta.shm_name)
                except FileNotFoundError:
                    return
            with open(path, "wb") as f:
                f.write(seg.buf[:e.meta.size])
            seg.close()
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
            e.segment = None
            e.meta.shm_name = None
        e.spilled_path = path
        e.meta.flags |= ObjectMeta.SPILLED
        self._used -= e.meta.size
        e.charged = False
        self.num_spilled += 1
        self.spilled_bytes_total += e.meta.size
        self._spill_events.append(("spill", e.meta.object_id, e.meta.size))

    # concurrency: requires(store.entries)
    def _restore(self, object_id: ObjectID, e: _Entry) -> None:
        self._ensure_capacity(e.meta.size)
        off = (self._arena.alloc(e.meta.size)
               if (self._arena is not None
                   and e.meta.size <= self.ARENA_MAX_OBJECT) else None)
        if off is not None:
            with open(e.spilled_path, "rb") as f:
                f.readinto(self._arena.buffer(off, e.meta.size))
            e.meta.arena_ref = (self._arena.path, off)
        else:
            seg = shared_memory.SharedMemory(
                create=True, size=max(e.meta.size, 1),
                name=_segment_name(object_id))
            self._manifest_add(seg.name)
            with open(e.spilled_path, "rb") as f:
                f.readinto(seg.buf[:e.meta.size])
            e.segment = seg
            e.meta.shm_name = seg.name
        os.unlink(e.spilled_path)
        e.spilled_path = None
        e.meta.flags &= ~ObjectMeta.SPILLED
        self._used += e.meta.size
        e.charged = True
        self.num_restored += 1
        self.restored_bytes_total += e.meta.size
        self._spill_events.append(("restore", e.meta.object_id, e.meta.size))

    def shutdown(self) -> None:
        with self._lock:
            self.free(list(self._entries))
            if self._arena is not None:
                self._arena.close(unlink=True)
                self._arena = None
            if self._manifest_f is not None:
                try:
                    self._manifest_f.close()
                    os.unlink(self._manifest_path)
                except OSError:
                    pass
                self._manifest_f = None


class _AdoptWriter:
    """Streaming target for a chunked cross-host pull — an unregistered
    arena block (preferred; OOB frames land with one mmap write) or a
    private segment. Not registered in the store until finish() — a
    half-written copy must never be readable (or freeable) under its
    object id."""

    def __init__(self, store: "ObjectStore", object_id: ObjectID, size: int,
                 segment: Optional[shared_memory.SharedMemory] = None,
                 arena_off: Optional[int] = None):
        self._store = store
        self._oid = object_id
        self._size = size
        self._segment = segment
        self._arena_off = arena_off
        self._buf = (store._arena.buffer(arena_off, size)
                     if arena_off is not None else None)

    def write(self, offset: int, data) -> None:
        if self._buf is not None:
            self._buf[offset:offset + len(data)] = data
        else:
            self._segment.buf[offset:offset + len(data)] = data

    def finish(self) -> ObjectMeta:
        if self._arena_off is not None:
            meta = ObjectMeta(object_id=self._oid, size=self._size,
                              arena_ref=(self._store._arena.path,
                                         self._arena_off))
        else:
            meta = ObjectMeta(object_id=self._oid, size=self._size,
                              shm_name=self._segment.name)
        if not self._store.adopt(meta):
            # a sealed copy landed mid-stream (e.g. local reconstruction
            # finished first): ours is redundant — free it or it leaks
            existing = self._store.get_meta(self._oid)
            self.abort()
            return existing if existing is not None else meta
        if self._segment is not None:
            self._segment.close()
        return meta

    def abort(self) -> None:
        if self._arena_off is not None:
            # never registered, never read: immediate free is safe
            self._buf = None
            self._store._arena.free(self._arena_off)
            self._arena_off = None
            return
        try:
            self._segment.close()
            self._segment.unlink()
        except OSError:
            pass


# --------------------------------------------------------------- client side

def read_wire_bytes(meta: ObjectMeta) -> Optional[bytes]:
    """Copy an object's serialized payload out of its backing storage
    (any same-host segment/arena, not necessarily this process's store).
    Used to inline payloads into replies for cross-host drivers."""
    if meta.inline is not None:
        return meta.inline
    if meta.arena_ref is not None:
        from . import native
        path, off = meta.arena_ref
        # tracked: the incref pins the block against spill/reuse for the
        # duration of the copy; raises FileNotFoundError on a stale meta
        # (block already freed) exactly like a vanished segment would
        return bytes(native.ArenaReader.get(path).tracked_buffer(
            off, meta.size))
    if meta.shm_name is not None:
        seg = attach_segment(meta.shm_name)
        try:
            return bytes(seg.buf[:meta.size])
        finally:
            seg.close()
    return None


@fieldsan.guarded
class ObjectReader:
    """Per-process cache of attached segments for zero-copy reads."""

    def __init__(self):
        self._segments: Dict[str, shared_memory.SharedMemory] = {}
        self._lock = locksan.lock("store.reader_segments")

    def load(self, meta: ObjectMeta):
        from . import serialization

        if meta.is_error():
            raise serialization.from_bytes(meta.error)
        if meta.inline is not None:
            return serialization.from_bytes(meta.inline)
        if meta.arena_ref is not None:
            from . import native
            path, off = meta.arena_ref
            reader = native.ArenaReader.get(path)
            # tracked_buffer increfs the block's cross-process mapper
            # refcount and decrefs when the last zero-copy view dies, so
            # the owner defers free/spill while this process reads.
            # FileNotFoundError (stale meta, block freed) propagates to
            # the client's bounded re-GET, same as a vanished segment.
            return serialization.read_from(
                reader.tracked_buffer(off, meta.size))
        with self._lock:
            seg = self._segments.get(meta.shm_name)
            if seg is None:
                seg = attach_segment(meta.shm_name)
                self._segments[meta.shm_name] = seg
        return serialization.read_from(seg.buf[:meta.size])

    def release(self, shm_name: str) -> None:
        with self._lock:
            seg = self._segments.pop(shm_name, None)
        if seg is not None:
            seg.close()

    def close(self) -> None:
        with self._lock:
            for seg in self._segments.values():
                try:
                    seg.close()
                except Exception:
                    pass
            self._segments.clear()
