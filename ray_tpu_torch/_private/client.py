"""CoreClient: the per-process runtime connecting to the node service.

Equivalent role to the reference's worker-side ``CoreWorker``
(``src/ray/core_worker/core_worker.h:285`` — Submit/Get/Put/Wait) plus the
Cython binding (``python/ray/_raylet.pyx:2947``). One instance per process:
the driver creates one in ``init()``; every worker process creates one at
registration. Request/reply correlation lives here; object payloads are
loaded zero-copy through ``ObjectReader``.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import exceptions
from . import context as _ctx
from . import fieldsan
from . import locksan
from . import protocol as P
from . import telemetry
from .config import CONFIG
from .ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID, WorkerID
from .object_ref import ObjectRef, ObjectRefGenerator
from .object_store import ObjectMeta, ObjectReader, create_segment
from . import serialization as ser


def _flat_bytes(smeta, views, total: int) -> bytes:
    """Write the (meta, buffers) wire format into one contiguous blob."""
    out = bytearray(total)
    ser.write_to(memoryview(out), smeta, views)
    return bytes(out)


# creation-callsite capture (reference analogue: the ReferenceCounter's
# per-ref callsites behind RAY_record_ref_creation_sites): the frame
# walk skips everything inside the ray_tpu package so a data-plane
# helper's internal put() is attributed to the user line that drove it
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep


def _callsite() -> str:
    """``dir/file.py:line`` of the nearest frame outside ray_tpu — a few
    ``f_back`` hops on the hot path; no ``inspect.stack()``, no file IO.
    Falls back to the innermost non-package-rooted form for calls with
    no user frame (runtime-internal puts)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_ROOT):
            parts = fn.split(os.sep)
            return f"{os.sep.join(parts[-2:])}:{f.f_lineno}"
        f = f.f_back
    return "<internal>"


def _creator_label() -> str:
    """Who is creating the object: the running task/actor-method name in
    a worker, else the driver."""
    name = _ctx.current_task_name
    return name if name else "driver"


@fieldsan.guarded
class CoreClient:
    def __init__(self, conn: P.Connection, job_id: JobID,
                 worker_id: WorkerID, kind: int):
        self.conn = conn
        self.job_id = job_id
        self.worker_id = worker_id
        self.kind = kind
        self.node_id = None         # set by driver init / worker runtime
        self.namespace = "default"  # set by init(namespace=...)
        # in-process NodeService when this driver runs on the head: large
        # puts then alloc/write/seal directly against the local store —
        # no ALLOC_OBJECT/PUT_OBJECT_SYNC round trips (reference
        # analogue: CoreWorker's local plasma client)
        self.local_node = None
        # Ray-Client-equivalent mode: this process shares no /dev/shm
        # with the node it is connected to, so object payloads must ride
        # the socket (set by init() when the head's host differs)
        self.wire_data_plane = False
        # worker runtime hooks: return unstarted leased tasks on block
        self.on_worker_block = None
        self.on_worker_unblock = None
        self.reader = ObjectReader()
        self._futures: Dict[int, Future] = {}
        self._req_lock = locksan.lock("client.req")
        self._next_req = 1
        conn.on_send_error = self._on_send_error
        self._registered_fns: set = set()
        self._reader_thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        # local reference counts per object; the node hears only the
        # 0→1 / 1→0 edges (reference: ``reference_count.h:61``).
        # ref_decr is called from ObjectRef.__del__, which cyclic GC may
        # run at ANY point — including while this thread already holds
        # _ref_lock — so decrements only append to a lock-free deque and
        # are applied under the lock by ref_incr or the flusher thread.
        # Edge order is captured by the shared buffer and batches leave
        # FIFO under _edge_flush_lock, so a register and a drop can
        # never reach the wire in inverted order (the socket write
        # itself stays OUT of _ref_lock — see flush_refs).
        self._ref_counts: Dict[ObjectID, int] = {}
        self._ref_lock = locksan.lock("client.ref")
        self._edge_flush_lock = locksan.lock("client.edge_flush")
        self._pending_decrs: "deque[ObjectID]" = deque()
        # creation provenance records (oid, callsite, creator), buffered
        # beside the edge stream and shipped as one OBJ_PROVENANCE frame
        # per flush (empty forever when object_callsite_enabled=0)
        self._prov_buf: List[tuple] = []
        # ordered edge stream, coalesced into one REF_BATCH frame — one
        # socket write per ~batch of submissions instead of one per ref.
        # Delayed registration is safe: an object only becomes freeable
        # once tracked, and tracking starts when the batch lands.
        self._edge_buf: List[Tuple[int, ObjectID]] = []
        self._flusher: Optional[threading.Thread] = None
        # Submission buffer: task/actor-call specs coalesce into one
        # SUBMIT_BATCH frame per flush — one pickle header + one syscall
        # + one dispatcher wakeup for a burst instead of one each
        # (reference analogue: the Cython submit path amortizes via the
        # C++ submit queue). Flushed before ANY other frame leaves this
        # client, so cross-op ordering is exactly the unbatched order.
        self._sub_buf: List[Tuple[int, Any]] = []
        self._sub_lock = locksan.lock("client.sub")
        # streaming-generator producer credit: {task_id: [consumed, Event]}
        # updated by GEN_ACK pushes; the executing thread waits on the
        # Event when its in-flight window fills
        self._gen_credit: Dict[TaskID, list] = {}
        self._gen_credit_lock = locksan.lock("client.gen_credit")

    # ------------------------------------------------------------ refcounts
    def ref_incr(self, oid: ObjectID) -> None:
        flush = False
        with self._ref_lock:
            self._apply_decrs_locked()
            n = self._ref_counts.get(oid, 0)
            self._ref_counts[oid] = n + 1
            if n == 0:
                self._edge_buf.append((P.REF_REGISTER, oid))
            flush = len(self._edge_buf) >= 256
        if flush:
            self.flush_refs()
        self._ensure_flusher()

    def ref_decr(self, oid: ObjectID) -> None:
        # GC-safe: deque.append is atomic and takes no lock
        self._pending_decrs.append(oid)

    def _note_provenance(self, oids: Sequence[ObjectID]) -> None:
        """Record the creation callsite for freshly-minted object ids
        (puts, task/actor-call returns, actor creation returns). One
        frame walk per call covers the whole id batch."""
        if not oids or not CONFIG.object_callsite_enabled:
            return
        cs = _callsite()
        creator = _creator_label()
        with self._ref_lock:
            for oid in oids:
                self._prov_buf.append((oid, cs, creator))
        telemetry.counter_inc(telemetry.M_OBJ_CALLSITES, float(len(oids)))

    # concurrency: requires(client.ref)
    def _apply_decrs_locked(self) -> None:
        while True:
            try:
                oid = self._pending_decrs.popleft()
            except IndexError:
                return
            n = self._ref_counts.get(oid, 0) - 1
            if n <= 0:
                self._ref_counts.pop(oid, None)
                self._edge_buf.append((P.REF_DROP, oid))
            else:
                self._ref_counts[oid] = n

    def flush_refs(self) -> None:
        """Synchronously emit buffered ref edges. Called at ordering
        boundaries: a worker flushes BEFORE sending TASK_DONE so borrows
        registered during execution land while the task's arg pins still
        hold; a driver flushes after get() so refs unpickled out of a
        returned value are registered promptly.

        The socket write happens OUTSIDE ``_ref_lock`` (it used to be
        inside, serializing every concurrent ``.remote()`` caller's
        ref_incr behind a peer's flush — measured as the top non-wait
        cost of n_n driver threads). Wire order is still exact: edge
        ORDER lives in the shared buffer, and ``_edge_flush_lock`` —
        held across take-and-send — keeps batches FIFO, so a register
        and a drop can never reach the wire inverted."""
        with self._edge_flush_lock:
            with self._ref_lock:
                self._apply_decrs_locked()
                if self._closed.is_set():
                    self._edge_buf.clear()
                    self._prov_buf.clear()
                    return
                batch, self._edge_buf = self._edge_buf, []
                prov, self._prov_buf = self._prov_buf, []
            if batch:
                try:
                    self._send(P.REF_BATCH, batch)  # lint: allow-under-lock(edge_flush exists to serialize take-and-send; FIFO wire order is the invariant)
                except OSError:
                    pass
        if prov:
            # provenance is order-independent of the edge stream (a
            # pure per-oid attribution table), so it ships OUTSIDE the
            # flush lock — no new blocking work under any lock
            try:
                self._send(P.OBJ_PROVENANCE, prov)
            except OSError:
                pass

    def _ensure_flusher(self) -> None:
        if self._flusher is not None and self._flusher.is_alive():
            return
        t = threading.Thread(target=self._flush_loop,
                             name="rtpu-ref-flusher", daemon=True)
        self._flusher = t
        t.start()

    def _flush_loop(self) -> None:
        # 50ms cadence bounds the latency of a fire-and-forget
        # submission that is never followed by a blocking op
        while not self._closed.wait(0.05):
            try:
                self.flush_submissions()
            except OSError:
                pass
            if self._pending_decrs or self._edge_buf or self._prov_buf:
                self.flush_refs()
        try:
            self.flush_submissions()
        except OSError:
            pass
        self.flush_refs()

    def _active_namespace(self) -> str:
        """Task-context namespace if set (worker executing a task), else
        this client's (driver) namespace — so nested submissions keep
        propagating the driver's namespace at any depth."""
        from . import context
        ns = context.current_namespace.get()
        return ns if ns is not None else self.namespace

    # ------------------------------------------------------------ lifecycle
    def start_reader(self) -> None:
        """Driver mode: own the receive loop. Workers route replies here
        from their main loop instead."""
        t = threading.Thread(target=self._read_loop, name="rtpu-client-reader",
                             daemon=True)
        t.start()
        self._reader_thread = t

    def _read_loop(self) -> None:
        while True:
            # burst receive: the node's writer coalesces replies/pushes,
            # so one wakeup often resolves a whole batch of futures
            msgs = self.conn.recv_many()
            if msgs is None:
                self._fail_all(ConnectionError("lost connection to node"))
                return
            for msg in msgs:
                self.handle_message(*msg)

    def _take_future(self, req_id: int) -> Optional[Future]:
        """Pop a reply future UNDER ``_req_lock``: the reader thread's
        pop used to race ``_fail_all`` (conn teardown / send-error on
        another thread), whose take-all-and-clear could hand the SAME
        future to both sides — set_result after set_exception raises
        InvalidStateError and killed the process's only reply-routing
        loop. dict.pop alone looked atomic; the snapshot in _fail_all
        is what made it a two-step race (found by fieldsan)."""
        with self._req_lock:
            return self._futures.pop(req_id, None)

    def handle_message(self, op: int, payload: Any) -> None:
        if op == P.PUT_REPLY:
            (req_id,) = payload
            fut = self._take_future(req_id)
            if fut is not None:
                fut.set_result(None)
        elif op in (P.GET_REPLY, P.KV_REPLY, P.NAMED_ACTOR_REPLY,
                    P.FUNCTION_REPLY, P.INFO_REPLY):
            req_id, value = payload
            fut = self._take_future(req_id)
            if fut is not None:
                fut.set_result(value)
        elif op == P.WAIT_REPLY:
            req_id, ready, pending = payload
            fut = self._take_future(req_id)
            if fut is not None:
                fut.set_result((ready, pending))
        elif op == P.ERROR_REPLY:
            req_id, err = payload
            fut = self._take_future(req_id)
            if fut is not None:
                fut.set_exception(ser.from_bytes(err))
        elif op == P.GEN_ACK:
            task_id, consumed = payload
            with self._gen_credit_lock:
                # Normal acks are update-only: production acks can't
                # precede gen_credit_init (items ship after it), and
                # creating on a late ack would leak one entry per stream
                # in a pooled worker. The synthetic INFINITE credit of an
                # early GEN_CLOSE is the exception — it may arrive before
                # the task even starts, and must survive until init's
                # setdefault finds it (gen_credit_drop then removes it).
                ev = self._gen_credit.get(task_id)
                if ev is None and consumed >= (1 << 62):
                    ev = self._gen_credit[task_id] = [consumed,
                                                      threading.Event()]
                elif ev is not None and consumed > ev[0]:
                    ev[0] = consumed
                if ev is not None:
                    ev[1].set()
        elif op == P.COLL_DELIVER:
            # collective chunk for a rank in this process: deposit on
            # THIS (reader) thread — the rank thread blocked in
            # coll_transport.wait() wakes under the condition variable
            from . import coll_transport
            coll_key, data = payload
            coll_transport.deposit(tuple(coll_key), data)
        elif op == P.STACK_DUMP:
            # answered from THIS (reader) thread on purpose: it is never
            # the one blocked in user code, so a process wedged in get()
            # still reports every thread's stack (reference: `ray stack`)
            from . import debugging
            try:
                dump = debugging.collect_stack_dump(
                    kind=("worker" if self.kind == P.KIND_WORKER
                          else "driver"),
                    worker_id=self.worker_id.hex())
                self.conn.send((P.STACK_REPLY, (payload, dump)))
            except Exception:   # noqa: BLE001 — debugging is best-effort
                pass
        elif op == P.COLL_PROGRESS:
            # flight-recorder watermark query, answered on THIS (reader)
            # thread like STACK_DUMP: the rank thread may be wedged
            # inside the very collective being diagnosed
            from . import flight_recorder
            try:
                snap = flight_recorder.progress_snapshot(
                    kind=("worker" if self.kind == P.KIND_WORKER
                          else "driver"),
                    worker_id=self.worker_id.hex())
                self.conn.send((P.COLL_PROGRESS_REPLY, (payload, snap)))
            except Exception:   # noqa: BLE001 — debugging is best-effort
                pass
        elif op == P.PROFILE_START:
            # guarded like STACK_DUMP: an exception here (malformed
            # payload, can't-start-thread) would kill this process's
            # only message-receive loop
            try:
                token, opts = payload
                from . import debugging
                debugging.profile_async(self.conn, token,
                                        dict(opts or {}),
                                        worker_id=self.worker_id.hex())
            except Exception:   # noqa: BLE001 — debugging is best-effort
                pass
        elif op == P.EVENT:
            channel, data = payload
            if channel == "LOG" and self.kind == P.KIND_DRIVER:
                self._print_remote_logs(data)
        elif op == P.SHUTDOWN:
            self._fail_all(ConnectionError("node shutting down"))

    @staticmethod
    def _print_remote_logs(data: dict) -> None:
        """Worker output on the driver's stdout, prefixed like the
        reference's ``(pid=..., ip=...)`` log prefixes. tqdm magic
        lines render as in-place progress instead (reference:
        ``experimental/tqdm_ray.py``)."""
        import sys as _sys

        from ..util import tqdm_ray
        # a labelled worker (serve replica: "deployment#tag") prints its
        # human name — `rtpu logs` / driver output greps by deployment
        who = data.get("label") or data.get("worker", "?")[:8]
        prefix = f"(worker {who} " \
                 f"node={data.get('node_id', '?')[:8]})"
        plain = [line for line in data.get("lines", ())
                 if not tqdm_ray.render_magic_line(line)]
        if plain:
            out = "".join(f"{prefix} {line}\n" for line in plain)
            _sys.stdout.write(out)
            _sys.stdout.flush()

    def _fail_all(self, exc: Exception) -> None:
        # _req_lock orders this against _request: a request registered
        # before the lock is failed here; one after it sees _closed set
        # and raises instead of registering an unresolvable future.
        with self._req_lock:
            self._closed.set()
            futures = list(self._futures.values())
            self._futures.clear()
        for fut in futures:
            if not fut.done():
                fut.set_exception(exc)

    def close(self) -> None:
        # push out buffered fire-and-forget submissions before tearing
        # down the socket — a side-effecting task submitted just before
        # shutdown() must still reach the node
        try:
            self.flush_submissions()
        except OSError:
            pass
        self._closed.set()
        self.reader.close()
        self.conn.close()

    # ------------------------------------------------------------- plumbing
    def _on_send_error(self, msg, exc: BaseException) -> None:
        P.fail_dropped_request(msg, exc, self._req_lock, self._futures)

    def _request(self, op: int, make_payload) -> Future:
        fut: Future = Future()
        with self._req_lock:
            if self._closed.is_set():
                raise ConnectionError("connection to node is closed")
            req_id = self._next_req
            self._next_req += 1
            self._futures[req_id] = fut
        self.flush_submissions()
        self.conn.send((op, make_payload(req_id)))
        return fut

    def _send(self, op: int, payload: Any) -> None:
        self.flush_submissions()
        self.conn.send((op, payload))

    def _send_submission(self, op: int, payload: Any) -> None:
        """Queue a task/actor-call submission for the next batch flush.
        A full buffer flushes inline; otherwise the ref-flusher thread or
        the next blocking op flushes within its cadence."""
        with self._sub_lock:
            self._sub_buf.append((op, payload))
            n = len(self._sub_buf)
        if n >= CONFIG.submit_batch_max_specs:
            self.flush_submissions()
        else:
            self._ensure_flusher()

    def gen_next(self, task_id: TaskID, index: int):
        """Consumer side: block until item ``index`` of a streaming task
        is available; returns ("item", meta) | ("end", count) |
        ("error", err_bytes)."""
        fut = self._request(P.GEN_NEXT, lambda rid: (rid, task_id, index))
        return self._blocking_result(fut)

    def gen_close(self, task_id: TaskID) -> None:
        self._send(P.GEN_CLOSE, (task_id,))

    def gen_credit_init(self, task_id: TaskID) -> None:
        """Register the credit slot BEFORE the first item ships: acks
        may arrive before the producer's first wait, and dropping them
        would deadlock a producer at exactly ``window`` items."""
        with self._gen_credit_lock:
            self._gen_credit.setdefault(task_id, [0, threading.Event()])

    def gen_wait_credit(self, task_id: TaskID, produced: int,
                        window: int) -> None:
        """Producer-side backpressure: block until the consumer has
        acked enough items that fewer than ``window`` are in flight.
        GEN_ACK pushes (handled on the worker's recv thread) advance the
        credit."""
        if window <= 0:
            return
        while not self._closed.is_set():
            with self._gen_credit_lock:
                ent = self._gen_credit.get(task_id)
                if ent is None or produced - ent[0] < window:
                    return
                ent[1].clear()
            ent[1].wait(timeout=1.0)

    def gen_credit_drop(self, task_id: TaskID) -> None:
        with self._gen_credit_lock:
            self._gen_credit.pop(task_id, None)

    def flush_submissions(self) -> None:
        # send while holding the lock: a concurrent later submission must
        # not reach the socket before this batch (actor per-submitter
        # order rides frame order)
        with self._sub_lock:
            if not self._sub_buf:
                return
            batch, self._sub_buf = self._sub_buf, []
            if len(batch) == 1:
                self.conn.send(batch[0])  # lint: allow-under-lock(a later submission must not reach the socket before this batch; actor per-submitter order rides frame order)
            else:
                self.conn.send((P.SUBMIT_BATCH, batch))  # lint: allow-under-lock(same FIFO invariant as the single-spec branch)

    # ------------------------------------------------------------- objects
    def put(self, value: Any) -> ObjectRef:
        from .object_ref import begin_ref_capture, end_ref_capture
        oid = ObjectID.for_put(self.worker_id)
        # the ref exists (and is registered) BEFORE any contained-ref
        # pin references it as holder — see _pin_contained below
        ref = ObjectRef(oid)
        self._note_provenance((oid,))
        begin_ref_capture()
        try:
            if self.wire_data_plane:
                flat = self._serialize_flat(value)
            else:
                meta, sealed = self._store_value(oid, value)
        finally:
            contained = end_ref_capture()
        self._pin_contained(oid, contained)
        if self.wire_data_plane:
            self._wire_put(oid, *flat)
            return ref
        if sealed:
            pass    # adopted + published in-process (head driver)
        elif meta.shm_name is not None or meta.arena_ref is not None:
            # Large object: block until the node store adopts it — a
            # returned ref IS sealed, matching the reference
            # (``core_worker.cc:1141``). A one-way seal was measured at
            # <3% on the put bench and let a returned ref race the
            # store's visibility/accounting; not worth the drift.
            self._sync_put(meta)
        else:
            self._send(P.PUT_OBJECT, meta)
        return ref

    def _pin_contained(self, oid: ObjectID, contained: list) -> None:
        """Refs pickled INSIDE a stored value would lose their last
        holder once the caller's own refs die (same deadlock class as
        refs nested in task returns): ship the containment edge so the
        plane pins them until the container is freed. flush_refs first
        so our REGISTER of the container reaches the plane before the
        pin checks for a live holder."""
        if not contained:
            return
        self.flush_refs()
        self._send(P.RETURN_REFS, (oid, contained))

    def _sync_put(self, meta: ObjectMeta) -> None:
        """Acked put of a shm-backed object; unlinks the segment if the
        node rejects it, since no store owns it then. (Arena-backed
        objects need no cleanup here: the allocation is owned by the
        node store from the Create.)"""
        try:
            self._request(P.PUT_OBJECT_SYNC,
                          lambda rid: (rid, meta)).result()
        except BaseException:
            if meta.shm_name is not None:
                from multiprocessing import shared_memory
                try:
                    seg = shared_memory.SharedMemory(name=meta.shm_name)
                    seg.close()
                    seg.unlink()
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
            raise

    def _store_value(self, oid: ObjectID, value: Any
                     ) -> Tuple[ObjectMeta, bool]:
        """Serialize a value; small inline, large into shm. Returns
        (meta, sealed) — sealed means the local fast path already
        adopted + published it and no PUT rpc is needed."""
        smeta, views = ser.serialize(value)
        total = ser.serialized_size(smeta, views)
        if total <= CONFIG.object_store_shm_threshold_bytes:
            return ObjectMeta(object_id=oid, size=total,
                              inline=_flat_bytes(smeta, views, total)), False
        meta = self._local_store_large(oid, smeta, views, total)
        if meta is not None:
            return meta, True
        return self.store_large(oid, smeta, views, total), False

    def _local_store_large(self, oid: ObjectID, smeta, views,
                           total: int) -> Optional[ObjectMeta]:
        """Head-driver fast path: the node service lives in THIS
        process, so allocate + write + seal directly against its store
        and publish the location — zero control-plane round trips for
        a large put (reference analogue: local plasma client)."""
        node = self.local_node
        if node is None or getattr(node, "dead", False):
            return None
        if CONFIG.object_store_lazy_put:
            try:
                meta = node.store.put_lazy(oid, smeta, views, total)
            except Exception:   # store unhealthy: RPC path decides
                return None
            if meta is not None:
                # zero bytes copied: the serialized views stay in this
                # process's heap until first cross-process demand (or
                # spill pressure) promotes them to the arena
                node._seal_object(meta)
                return meta
            return None         # duplicate put: RPC path decides
        try:
            buf, meta = node.store.create_local(oid, total)
        except Exception:       # store full / duplicate: RPC path decides
            return None
        try:
            ser.write_to(buf, smeta, views)
            node.store.seal(oid)
        except BaseException:
            # a failed fill (exporter error, KeyboardInterrupt) must not
            # leave a permanently unsealed, budget-charged entry behind
            del buf             # release the view before the arena/shm free
            node.store.abort_create(oid)
            raise
        node._seal_object(meta)     # re-adopt no-ops; publishes location
        return meta

    @staticmethod
    def _serialize_flat(value: Any) -> Tuple[bytes, int]:
        smeta, views = ser.serialize(value)
        total = ser.serialized_size(smeta, views)
        return _flat_bytes(smeta, views, total), total

    def _wire_put(self, oid: ObjectID, data: bytes, total: int) -> None:
        """Cross-host put: the payload rides the socket (out-of-band as
        a zero-copy iovec when large) and the NODE materializes it as
        the primary copy (we have no shared shm)."""
        if total <= CONFIG.object_store_shm_threshold_bytes:
            self._send(P.PUT_OBJECT,
                       ObjectMeta(object_id=oid, size=total, inline=data))
        else:
            self._request(P.PUT_OBJECT_WIRE,
                          lambda rid: (rid, oid, P.oob_wrap(data))).result()

    def store_large(self, oid: ObjectID, smeta, views,
                    total: int) -> ObjectMeta:
        """Write a large payload into shm: arena Create/Seal when the
        node store offers an arena slot (one mmap per process,
        ``native/object_arena.cpp``), else a dedicated segment."""
        from . import native
        if CONFIG.use_native_arena and native.available():
            try:
                ref = self._request(P.ALLOC_OBJECT,
                                    lambda rid: (rid, oid, total)).result()
            except Exception:
                ref = None
            if ref is not None:
                path, off = ref
                reader = native.ArenaReader.get(path)
                ser.write_to(reader.buffer(off, total), smeta, views)
                return ObjectMeta(object_id=oid, size=total,
                                  arena_ref=(path, off))
        seg = create_segment(oid, total)
        ser.write_to(seg.buf, smeta, views)
        name = seg.name
        seg.close()
        return ObjectMeta(object_id=oid, size=total, shm_name=name)

    @property
    def _get_op(self) -> int:
        return (P.GET_OBJECTS_FETCH if self.wire_data_plane
                else P.GET_OBJECTS)

    def _blocking_result(self, fut: Future):
        """Await a get/wait reply; a worker mid-task that actually has
        to WAIT tells its node first, so the node returns the task's CPU
        and the children being waited on can run (reference:
        ``NotifyDirectCallTaskBlocked`` — without this, nested
        submission deadlocks once parents hold every CPU). The short
        probe keeps already-ready gets off the notify path."""
        from . import context as _ctx
        in_task = (self.kind == P.KIND_WORKER
                   and _ctx.current_task_id is not None)
        if not in_task:
            return fut.result()
        try:
            return fut.result(timeout=0.004)
        except FuturesTimeout:
            pass
        if self.on_worker_block is not None:
            # hand back unstarted leased tasks BEFORE announcing the
            # block: they may be the very children this get() waits on
            self.on_worker_block()
        self._send(P.NOTIFY_BLOCKED, None)
        try:
            return fut.result()
        finally:
            self._send(P.NOTIFY_UNBLOCKED, None)
            if self.on_worker_unblock is not None:
                self.on_worker_unblock()

    def get(self, refs: Sequence[ObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        ids = [r.id for r in refs]
        fut = self._request(self._get_op,
                            lambda rid: (rid, ids, timeout))
        metas = self._blocking_result(fut)
        out = []
        for ref, m in zip(refs, metas):
            out.append(self._load_meta(ref, m, timeout))
        self.flush_refs()   # register refs unpickled from the values
        return out

    def _load_meta(self, ref: ObjectRef, meta: ObjectMeta,
                   timeout: Optional[float] = None) -> Any:
        # The owner may spill (and unlink) the segment between the meta
        # reply and our attach; a fresh GET restores it at the owning
        # store, so retry a couple of times before giving up. The retry
        # keeps the caller's timeout so get(timeout=...) stays bounded.
        for attempt in range(3):
            if meta is None:
                # lost between readiness and lookup (or the wire-fetch
                # payload vanished mid-copy); retry once, then surface
                if attempt == 2:
                    break
            else:
                try:
                    return self.reader.load(meta)
                except FileNotFoundError:
                    if attempt == 2:
                        raise
                    self.reader.release(meta.shm_name)
            meta = self._request(
                self._get_op,
                lambda rid: (rid, [ref.id], timeout)).result()[0]
        from ..exceptions import ObjectLostError
        raise ObjectLostError(ref.id, "object vanished during get()")

    def wait(self, refs: Sequence[ObjectRef], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        ids = [r.id for r in refs]
        fut = self._request(P.WAIT_OBJECTS,
                            lambda rid: (rid, ids, num_returns, timeout))
        ready_ids, pending_ids = self._blocking_result(fut)
        ready_set = set(ready_ids)
        ready = [r for r in refs if r.id in ready_set]
        pending = [r for r in refs if r.id not in ready_set]
        return ready, pending

    def free(self, refs: Sequence[ObjectRef]) -> None:
        ids = [r.id for r in refs]
        node = self.local_node
        if node is not None and not getattr(node, "dead", False):
            # head driver: free synchronously against the in-process
            # store (mirrors the local put fast path — a put loop that
            # frees as it goes must not outrun socket-borne frees and
            # push the store into spilling). Only ids the store has
            # already SEALED are eligible: an inline put rides the
            # socket as a fire-and-forget PUT_OBJECT, and an in-process
            # free must not overtake that queued frame (the
            # late-arriving put would resurrect the freed object) —
            # unsealed ids ride the same socket so the node applies put
            # and free in order.
            try:
                local = [oid for oid in ids if node.store.contains(oid)]
                if local:
                    for oid in local:
                        node.gcs.drop_location(oid)
                    node.store.free(local)
                    if len(local) == len(ids):
                        return
                    done = set(local)
                    ids = [oid for oid in ids if oid not in done]
            except Exception:   # noqa: BLE001 — fall back to the RPC
                pass
        self._send(P.FREE_OBJECTS, ids)

    def as_future(self, ref: ObjectRef) -> Future:
        out: Future = Future()

        def _attempt(attempts_left: int):
            def _resolve(fut: Future):
                try:
                    meta = fut.result()[0]
                    if meta is None:
                        from ..exceptions import ObjectLostError
                        if attempts_left > 0:
                            _attempt(attempts_left - 1)
                        else:
                            out.set_exception(ObjectLostError(
                                ref.id, "object vanished during get()"))
                        return
                    out.set_result(self.reader.load(meta))
                except FileNotFoundError:
                    # Segment spilled between reply and attach. This
                    # callback runs on the reply-routing thread, so retry
                    # asynchronously (a blocking re-request here would
                    # deadlock the thread that must process its reply).
                    if attempts_left > 0:
                        _attempt(attempts_left - 1)
                    else:
                        out.set_exception(
                            FileNotFoundError(f"object {ref.id} segment "
                                              "disappeared repeatedly"))
                except BaseException as e:  # noqa: BLE001
                    out.set_exception(e)

            inner = self._request(self._get_op,
                                  lambda rid: (rid, [ref.id], None))
            inner.add_done_callback(_resolve)

        _attempt(2)
        return out

    # ---------------------------------------------------------------- args
    def pack_args(self, args: tuple, kwargs: dict):
        packed = [self._pack_one(a) for a in args]
        pkw = {k: self._pack_one(v) for k, v in kwargs.items()}
        return packed, pkw

    def _pack_one(self, value: Any) -> Tuple[str, Any]:
        from .object_ref import begin_ref_capture, end_ref_capture
        if isinstance(value, ObjectRef):
            return ("r", value.id)
        begin_ref_capture()
        try:
            smeta, views = ser.serialize(value)
        finally:
            contained = end_ref_capture()
        total = ser.serialized_size(smeta, views)
        if total <= CONFIG.object_store_shm_threshold_bytes:
            out = bytearray(total)
            ser.write_to(memoryview(out), smeta, views)
            return ("v", bytes(out))
        # Large argument: implicit put, pass by reference. Synchronous for
        # the same reason as put(): the store's budget accounting must not
        # lag behind a writer looping over f.remote(big_array).
        oid = ObjectID.for_put(self.worker_id)
        implicit_ref = ObjectRef(oid)       # holder for _pin_contained
        self._note_provenance((oid,))
        self._pin_contained(oid, contained)
        if self.wire_data_plane:
            self._wire_put(oid, _flat_bytes(smeta, views, total), total)
            return ("r", implicit_ref.id)
        meta = self._local_store_large(oid, smeta, views, total)
        if meta is None:
            meta = self.store_large(oid, smeta, views, total)
            self._sync_put(meta)
        return ("r", implicit_ref.id)

    # ---------------------------------------------------------------- tasks
    def ensure_function(self, function_id: bytes, blob_fn) -> None:
        if function_id in self._registered_fns:
            return
        self._send(P.KV_PUT, (b"fn:" + function_id, blob_fn(), False))
        self._registered_fns.add(function_id)

    def submit_task(self, function_id: bytes, name: str, args, kwargs,
                    num_returns: int, resources: Dict[str, float],
                    max_retries: int, scheduling_strategy=None,
                    retry_exceptions: bool = False,
                    runtime_env: Optional[dict] = None) -> List[ObjectRef]:
        task_id = TaskID.for_job(self.job_id)
        packed, pkw = self.pack_args(args, kwargs)
        streaming = num_returns == -1
        return_ids = ([] if streaming
                      else [ObjectID.for_task_return(task_id, i)
                            for i in range(num_returns)])
        spec = P.TaskSpec(
            task_id=task_id, job_id=self.job_id, name=name,
            function_id=function_id, args=packed, kwargs=pkw,
            num_returns=num_returns, return_ids=return_ids,
            resources=resources,
            # no lineage reconstruction of partially-consumed streams
            # (the reference restricts retries of generators similarly)
            max_retries=0 if streaming else max_retries,
            retry_exceptions=retry_exceptions,
            scheduling_strategy=scheduling_strategy,
            owner_id=self.worker_id.binary(),
            namespace=self._active_namespace(),
            runtime_env=runtime_env,
            trace_context=self._trace_context(),
            request_ctx=_ctx.request_ctx.get())
        self._note_provenance(return_ids)
        self._send_submission(P.SUBMIT_TASK, spec)
        if streaming:
            return ObjectRefGenerator(task_id)
        return [ObjectRef(oid) for oid in return_ids]

    @staticmethod
    def _trace_context() -> Optional[dict]:
        from ..util import tracing
        return tracing.propagation_context()

    def send_profile_event(self, kind: str, payload) -> None:
        self._send(P.PROFILE_EVENT, (kind, payload))

    def create_actor(self, spec: P.ActorSpec) -> None:
        if spec.creation_return_id is not None:
            self._note_provenance((spec.creation_return_id,))
        self._send(P.CREATE_ACTOR, spec)

    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          args, kwargs, num_returns: int, seq_no: int,
                          name: str = "") -> List[ObjectRef]:
        task_id = TaskID.for_job(self.job_id)
        packed, pkw = self.pack_args(args, kwargs)
        streaming = num_returns == -1
        return_ids = ([] if streaming
                      else [ObjectID.for_task_return(task_id, i)
                            for i in range(num_returns)])
        spec = P.TaskSpec(
            task_id=task_id, job_id=self.job_id,
            name=name or method_name, function_id=b"",
            args=packed, kwargs=pkw, num_returns=num_returns,
            return_ids=return_ids, resources={},
            actor_id=actor_id, method_name=method_name, seq_no=seq_no,
            owner_id=self.worker_id.binary(),
            namespace=self._active_namespace(),
            trace_context=self._trace_context(),
            request_ctx=_ctx.request_ctx.get())
        self._note_provenance(return_ids)
        self._send_submission(P.SUBMIT_ACTOR_TASK, spec)
        if streaming:
            return ObjectRefGenerator(task_id)
        return [ObjectRef(oid) for oid in return_ids]

    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        self._send(P.KILL_ACTOR, (actor_id, no_restart))

    def save_actor_checkpoint(self, actor_id: ActorID, seq: int,
                              blob: bytes) -> bool:
        """Persist one actor-state snapshot in the control plane.
        SYNCHRONOUS on purpose: the worker checkpoints before reporting
        the triggering call done, so a completion the caller observed
        is never ahead of the state a restart would restore. Large
        blobs ride out-of-band (zero-copy iovec)."""
        return self._request(
            P.ACTOR_CHECKPOINT,
            lambda rid: (rid, actor_id, seq, P.oob_wrap(blob))).result()

    def get_actor_checkpoint(self, actor_id: ActorID):
        """(seq, blob) of the actor's latest checkpoint, or None."""
        return self._request(
            P.ACTOR_CHECKPOINT_GET, lambda rid: (rid, actor_id)).result()

    def actor_exit(self, actor_id: ActorID, reason: str) -> None:
        """Worker-side intentional exit of its own actor (the send half
        of ``ray_tpu.exit_actor()``)."""
        self._send(P.ACTOR_EXIT, (actor_id, reason))

    def cancel_task(self, task_id: TaskID, force: bool) -> None:
        self._send(P.CANCEL_TASK, (task_id, force))

    def get_named_actor(self, name: str, namespace: str) -> Optional[dict]:
        fut = self._request(P.GET_NAMED_ACTOR,
                            lambda rid: (rid, name, namespace))
        return fut.result()

    def fetch_function(self, function_id: bytes) -> Optional[bytes]:
        fut = self._request(P.FETCH_FUNCTION, lambda rid: (rid, function_id))
        return fut.result()

    # ------------------------------------------------------------------ kv
    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True) -> None:
        self._send(P.KV_PUT, (key, value, overwrite))

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self._request(P.KV_GET, lambda rid: (rid, key)).result()

    def kv_del(self, key: bytes) -> None:
        self._send(P.KV_DEL, key)

    def kv_keys(self, prefix: bytes) -> List[bytes]:
        return self._request(P.KV_KEYS, lambda rid: (rid, prefix)).result()

    # ---------------------------------------------------------------- info
    def cluster_info(self, what: str) -> Any:
        return self._request(P.CLUSTER_INFO, lambda rid: (rid, what)).result()

    def state_query(self, what: str, filters=None) -> Any:
        return self._request(P.STATE_QUERY,
                             lambda rid: (rid, what, filters)).result()

    def cluster_stacks(self, timeout_s: float = 5.0) -> Any:
        """Thread dumps of every node/worker/driver process, aggregated
        and deduplicated by the control plane (reference: `ray stack`)."""
        return self._request(
            P.CLUSTER_STACKS,
            lambda rid: (rid, timeout_s)).result(timeout=timeout_s + 30.0)

    def cluster_profile(self, opts: dict) -> Any:
        """Cluster-wide sampling profile; blocks for the duration."""
        duration = float(opts.get("duration_s", 5.0))
        return self._request(
            P.CLUSTER_PROFILE,
            lambda rid: (rid, dict(opts))).result(timeout=duration + 60.0)

    def collective_health(self, timeout_s: float = 2.0) -> Any:
        """Cluster-wide collective hang diagnosis: every rank's flight-
        recorder watermarks, diffed into verdicts (dead rank / lost
        chunk / lagging rank). Workers call this too — a rank that just
        timed out diagnoses the hang before surfacing it."""
        return self._request(
            P.CLUSTER_COLL,
            lambda rid: (rid, "health", timeout_s)).result(
                timeout=timeout_s + 30.0)

    def flight_records(self, timeout_s: float = 2.0) -> Any:
        """Every process's recent flight-recorder events + completed-op
        records (the raw material behind ``state.flight_records()`` and
        the timeline's collective spans)."""
        return self._request(
            P.CLUSTER_COLL,
            lambda rid: (rid, "records", timeout_s)).result(
                timeout=timeout_s + 30.0)

    def create_placement_group(self, spec: P.PlacementGroupSpec):
        return self._request(P.CREATE_PG, lambda rid: (rid, spec)).result()

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        self._send(P.REMOVE_PG, pg_id)


def function_id_of(blob: bytes) -> bytes:
    return hashlib.sha1(blob).digest()
