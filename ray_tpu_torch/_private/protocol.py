"""Wire protocol between drivers/workers and the node service.

Equivalent role to the reference's gRPC surface (``protobuf/core_worker.proto``,
``node_manager.proto``): task push, object status, actor control. We use
length-prefixed pickled frames over unix-domain sockets — the control plane
is local to a host; cross-host transfer rides the object plane (shm on one
host, chunked TCP between hosts in the multi-node deployment).

The transport batches and scatter-gathers (see ``Connection``): sends go
through a per-connection bounded queue drained by a writer thread that
coalesces every pending message into as few frames and ``sendmsg`` calls
as possible, and large buffers ride out-of-band as iovecs (pickle
protocol 5) instead of being copied through the pickle stream.
"""

from __future__ import annotations

import pickle
import socket
import struct
import sys
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import fieldsan
from . import locksan
from . import telemetry
from .config import CONFIG
from .ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID

# ----------------------------------------------------------------- opcodes
# client -> service
REGISTER = 1            # (kind, worker_id, pid)
SUBMIT_TASK = 2         # TaskSpec
CREATE_ACTOR = 3        # ActorSpec
SUBMIT_ACTOR_TASK = 4   # TaskSpec (actor_id set)
PUT_OBJECT = 5          # ObjectMeta
GET_OBJECTS = 6         # (req_id, [ObjectID], timeout_s|None)
WAIT_OBJECTS = 7        # (req_id, [ObjectID], num_returns, timeout_s)
FREE_OBJECTS = 8        # [ObjectID]
KILL_ACTOR = 9          # (ActorID, no_restart)
CANCEL_TASK = 10        # (TaskID, force)
GET_NAMED_ACTOR = 11    # (req_id, name, namespace)
# op 22 retired: SUBSCRIBE_EVENTS, superseded by GCS_SUBSCRIBE (op 36)
KV_PUT = 12             # (key, value, overwrite)
KV_GET = 13             # (req_id, key)
KV_DEL = 14             # key
KV_KEYS = 15            # (req_id, prefix)
FETCH_FUNCTION = 16     # (req_id, function_id)
CLUSTER_INFO = 17       # (req_id, what)
TASK_DONE = 18          # (task_id, [ObjectMeta], error|None, is_actor_creation)
CREATE_PG = 19          # PlacementGroupSpec
REMOVE_PG = 20          # PlacementGroupID
ACTOR_EXIT = 21         # (actor_id, reason)
STATE_QUERY = 23        # (req_id, what, filters)
PROFILE_EVENT = 24      # (kind, payload)
PUT_OBJECT_SYNC = 25    # (req_id, ObjectMeta) — acked once the store adopts it
ALLOC_OBJECT = 26       # (req_id, ObjectID, size) — arena Create; reply
                        # INFO_REPLY (arena_path, offset) | None

# node <-> node (network plane; reference analogues:
# ``node_manager.proto:363`` RequestWorkerLease/forwarding and
# ``object_manager.h:117`` Push/Pull)
NODE_POST = 27          # item tuple, enqueued on the peer's event loop
OBJ_GET_META = 28       # (req_id, ObjectID, pin) -> INFO_REPLY meta|None
OBJ_UNPIN = 29          # ObjectID
# op 30 retired: whole-payload OBJ_PULL, superseded by OBJ_PULL_CHUNK
PG_RESERVE = 31         # (req_id, pg_key, demand) -> INFO_REPLY bool
PG_RELEASE = 32         # pg_key
NODE_STATS = 33         # (req_id, what) -> INFO_REPLY payload

# client/node <-> GCS service (reference: ``gcs_service.proto:63-699``)
GCS_CALL = 34           # (req_id, method, args, kwargs) -> INFO_REPLY
GCS_CAST = 35           # (method, args, kwargs) — no reply (hot mutators)
GCS_SUBSCRIBE = 36      # channel — pushes EVENT (channel, payload) frames

# distributed reference counting (reference: ``reference_count.h:61``)
REF_REGISTER = 37       # ObjectID — this client now holds a reference
REF_DROP = 38           # ObjectID — this client's last local ref died
REF_BATCH = 39          # [(op, ObjectID), ...] — coalesced edge stream

# Cross-host driver data plane (Ray-Client-equivalent attach: the driver
# shares no /dev/shm with the cluster, so payloads ride the socket).
# Numbered after the reply range — 40-51 are already taken below.
GET_OBJECTS_FETCH = 52  # (req_id, [ObjectID], timeout) — GET_REPLY metas
                        # with shm/arena payloads converted to inline
PUT_OBJECT_WIRE = 53    # (req_id, ObjectID, bytes) — node materializes
                        # the payload in ITS store and seals

# Worker blocked in a get(): release its CPU so nested tasks can run
# (reference: NotifyDirectCallTaskBlocked/Unblocked, core_worker.cc)
NOTIFY_BLOCKED = 54     # no payload
NOTIFY_UNBLOCKED = 55   # no payload

# Chunked cross-host pull (reference: object_manager.h:117 Push/Pull in
# bounded chunks — a multi-GB object must never be one socket frame)
OBJ_PULL_CHUNK = 56     # (req_id, ObjectID, offset, length)
                        # -> INFO_REPLY (meta, bytes|None)|None

# Coalesced submission stream: [(SUBMIT_TASK|SUBMIT_ACTOR_TASK, spec),
# ...] — one frame + one dispatcher wakeup per burst (reference
# analogue: the C++ submit queue amortizing per-call overhead)
SUBMIT_BATCH = 57

# Streaming generator returns (reference: ReportGeneratorItemReturns,
# ``core_worker.proto:396``; consumer surface ``_raylet.pyx:252``
# ObjectRefGenerator)
GEN_ITEM = 58           # worker -> node: (task_id, index, ObjectMeta)
GEN_ACK = 59            # node -> worker push: (task_id, consumed_count)
GEN_NEXT = 60           # (req_id, task_id, index) -> INFO_REPLY
                        #   ("item", meta) | ("end", count)
                        #   | ("error", err_bytes)
GEN_CLOSE = 61          # (task_id,) — consumer dropped the generator
EXECUTE_BATCH = 62      # node -> worker: [EXECUTE_TASK payload, ...]
# op 63 reserved (was TASK_DONE_BATCH; DONEs leave per task so an
# early result is never withheld behind a slow batch successor —
# transport-level write coalescing now batches them without withholding)
CANCEL_QUEUED = 64      # node -> worker: task_id queued behind current
RETURN_LEASED = 65      # worker -> node: [(task_id, lease_seq)] unstarted
                        # leased tasks, each echoing its grant's seq so a
                        # stale rescue can never un-assign a newer grant
RETURN_REFS = 66        # worker -> node: (return_oid, [contained oids]) —
                        # refs pickled INSIDE a return; pinned until the
                        # return object is freed (sent before TASK_DONE)

# Distributed debugging (reference analogues: ``ray stack`` shelling
# py-spy over worker pids, and the profiling hooks). Collection fans
# out over the node plane; per-process replies ride the same conn the
# request arrived on, answered by the RECEIVER's reader thread — which
# is never the thread blocked in user code, so a worker wedged in get()
# still reports its stack.
CLUSTER_STACKS = 67     # driver -> node: (req_id, timeout_s)
                        # -> INFO_REPLY {"nodes": {...}, "groups": [...]}
CLUSTER_PROFILE = 68    # driver -> node: (req_id, opts dict)
                        # -> INFO_REPLY {"nodes": {...}, "collapsed": {...}}
STACK_DUMP = 69         # node -> worker/driver push: token
STACK_REPLY = 70        # worker/driver -> node: (token, dump dict)
PROFILE_START = 71      # node -> worker push: (token, opts dict)
PROFILE_REPORT = 72     # worker -> node: (token, report dict)

# Collective data plane (reference analogues: the ring/tree schedules of
# NCCL-backed ``util/collective`` — here the chunks ride the node plane).
# A rank addresses a peer rank by (node_id, worker_id) endpoint; its node
# routes each chunk either to a local process's conn or across the node
# plane, and payload tensors travel out-of-band (pickle-5 iovecs) on
# every hop. Handled on reader threads end to end — never the
# dispatcher — so collective traffic cannot queue behind task dispatch.
COLL_ROUTE = 74         # client -> node: (dst_node, dst_worker, key, payload)
COLL_FWD = 75           # node -> node: same body, deliver on the dst node
COLL_DELIVER = 76       # node -> client push: (key, payload) — deposited
                        # into the process mailbox (coll_transport.py)

# Collective flight-recorder progress plane (reference analogue: the
# NCCL flight recorder's dump collection). COLL_PROGRESS is pushed to
# every worker/driver conn and answered on the RECEIVER's reader thread
# — like STACK_DUMP, so a rank wedged inside a collective wait still
# reports its watermarks. CLUSTER_COLL is the driver/worker-facing
# collection op: the node fans out locally and across the node plane
# (NODE_STATS ("coll", timeout)) and replies with the aggregated
# snapshots or the diagnosed health report.
COLL_PROGRESS = 77      # node -> worker/driver push: token
COLL_PROGRESS_REPLY = 78  # worker/driver -> node: (token, snapshot dict)
CLUSTER_COLL = 79       # any client -> node: (req_id, what, timeout_s)
                        # what = "health" | "records" -> INFO_REPLY dict

# Object ownership/provenance plane (reference analogue: the
# ReferenceCounter's per-ref creation callsites behind
# RAY_record_ref_creation_sites, surfaced by `ray memory`). Clients
# buffer (oid, callsite, creator) records per put()/.remote() and flush
# them alongside the ref-edge stream; the node applies them to the
# control-plane provenance table so every object in the ledger knows
# who made it and from where.
OBJ_PROVENANCE = 80     # [(ObjectID, callsite, creator), ...]

# Checkpointable actors (reference analogue: the GCS-backed actor
# checkpointing of gcs.proto's ActorCheckpointData — state captured by
# an opt-in save_checkpoint()/restore_checkpoint(state) protocol). The
# blob lives in the CONTROL PLANE, not the checkpointing node's object
# store: a checkpoint must survive the death of the very node that
# wrote it, or a node-death restart restores nothing.
ACTOR_CHECKPOINT = 81       # (req_id, ActorID, seq, blob) -> INFO_REPLY
                            # True once the plane holds it (the worker
                            # blocks: a reported completion implies its
                            # checkpoint is durable)
ACTOR_CHECKPOINT_GET = 82   # (req_id, ActorID) -> INFO_REPLY
                            # (seq, blob) | None — replayed into a
                            # restarted actor before queued calls drain
SET_LOG_LABEL = 83          # worker -> node: label str — this worker's
                            # log lines should carry a human name (e.g.
                            # a serve replica's "deployment#tag") in
                            # the driver's "(worker ...)" prefix
                            # instead of a bare worker id

# Generic coalesced frame: (BATCH, [(op, payload), ...]). Produced by
# the Connection writer when several messages are pending at flush time
# — ONE pickle stream + one frame + one receiver wakeup for the burst —
# and expanded transparently by the Connection decoder, so dispatch
# code never sees it. Unlike SUBMIT_BATCH (a scheduler-level op with
# one-dispatch-pass semantics) this is pure transport.
BATCH = 73

# service -> client
EXECUTE_TASK = 40       # (kind, TaskSpec, resolved deps, ActorSpec|None,
                        # lease_seq) — seq names this grant in the
                        # sequenced lease handshake (0 for actor calls)
GET_REPLY = 41          # (req_id, [ObjectMeta])
WAIT_REPLY = 42         # (req_id, [ready ObjectID], [pending ObjectID])
NAMED_ACTOR_REPLY = 43  # (req_id, actor_info | None)
KV_REPLY = 44           # (req_id, value)
FUNCTION_REPLY = 45     # (req_id, blob | None)
INFO_REPLY = 46         # (req_id, payload)
# op 47 retired: ACTOR_STATE pushes, superseded by the GCS "ACTOR"
# pubsub channel (EVENT frames)
SHUTDOWN = 48           # ()
EVENT = 49              # (channel, payload)
ERROR_REPLY = 50        # (req_id, pickled exception)
PUT_REPLY = 51          # (req_id,)

KIND_DRIVER = 0
KIND_WORKER = 1


# ------------------------------------------------------------------- specs

def _mk_task_spec(t: tuple) -> "TaskSpec":
    """Rebuild a TaskSpec from its flattened wire tuple (see
    ``TaskSpec.__reduce__``). Positional layout == dataclass field
    order; __new__ + direct assignment skips __init__ overhead."""
    s = TaskSpec.__new__(TaskSpec)
    (tid, jid, s.name, s.function_id, s.args, s.kwargs, s.num_returns,
     rids, s.resources, s.max_retries, s.retry_exceptions, aid,
     s.method_name, s.seq_no, s.scheduling_strategy, s.owner_id,
     s.origin_node_id, s.namespace, s.runtime_env, s.trace_context,
     s.accel_ids, s.request_ctx) = t
    s.task_id = TaskID(tid)
    s.job_id = JobID(jid)
    s.return_ids = [ObjectID(b) for b in rids]
    s.actor_id = ActorID(aid) if aid is not None else None
    return s


@dataclass
class TaskSpec:
    """Immutable description of a task invocation.

    Reference analogue: ``TaskSpecification``
    (``src/ray/common/task/task_spec.h:244``).
    """

    task_id: TaskID
    job_id: JobID
    name: str
    function_id: bytes                       # content hash of the pickled fn
    # each arg: ("v", wire_bytes) inline value | ("r", ObjectID) reference
    args: List[Tuple[str, Any]] = field(default_factory=list)
    kwargs: Dict[str, Tuple[str, Any]] = field(default_factory=dict)
    num_returns: int = 1
    return_ids: List[ObjectID] = field(default_factory=list)
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 0
    retry_exceptions: bool = False
    # actor-related
    actor_id: Optional[ActorID] = None       # set for actor method calls
    method_name: str = ""
    seq_no: int = 0                          # actor call ordering
    # scheduling
    scheduling_strategy: Any = None          # None | "SPREAD" | NodeAffinity | PG
    owner_id: bytes = b""                    # WorkerID binary of the submitter
    # NodeID binary of the node that owns/routes this task; a starved
    # target spills the task back here for re-routing (reference
    # analogue: lease spillback keeps the owner in the loop)
    origin_node_id: bytes = b""
    namespace: str = "default"               # submitter's job namespace
    runtime_env: Optional[dict] = None       # validated runtime env
    # tracing: caller's (trace_id, span_id), propagated into the worker
    # (reference: ray.util.tracing traceparent in the task spec)
    trace_context: Optional[dict] = None
    # per-instance accelerator slots assigned by the executing node at
    # dispatch (reference: resource-instance ids / GPU id assignment);
    # read via get_runtime_context().get_accelerator_ids()
    accel_ids: Optional[List[int]] = None
    # request-scoped baggage (serve request ids; reference analogue:
    # W3C baggage): submitter's context.request_ctx tuple, re-bound by
    # the executing worker so the request's whole call tree carries it
    request_ctx: Optional[tuple] = None

    def __reduce__(self):
        # Hot-path serialization: a task spec crosses the wire 2-3 times
        # per invocation (submit, dispatch, peer forward). The default
        # dataclass pickle costs ~28us/spec (per-object reduce of every
        # ID); flattening to one tuple with IDs as raw bytes is ~8us.
        # tests/test_core_basic.py::test_spec_wire_roundtrip guards the
        # field list against drift.
        return (_mk_task_spec, (
            (self.task_id.binary(), self.job_id.binary(), self.name,
             self.function_id, self.args, self.kwargs, self.num_returns,
             [r.binary() for r in self.return_ids], self.resources,
             self.max_retries, self.retry_exceptions,
             self.actor_id.binary() if self.actor_id else None,
             self.method_name, self.seq_no, self.scheduling_strategy,
             self.owner_id, self.origin_node_id, self.namespace,
             self.runtime_env, self.trace_context, self.accel_ids,
             self.request_ctx),))


@dataclass
class ActorSpec:
    """Actor creation description (reference: actor creation TaskSpec +
    ``gcs_actor_manager.h:281`` registration payload)."""

    actor_id: ActorID
    job_id: JobID
    name: str                                # class name for display
    registered_name: Optional[str] = None    # named-actor name
    namespace: str = "default"
    class_blob: bytes = b""                  # cloudpickled class
    args: List[Tuple[str, Any]] = field(default_factory=list)
    kwargs: Dict[str, Tuple[str, Any]] = field(default_factory=dict)
    resources: Dict[str, float] = field(default_factory=dict)
    max_restarts: int = 0
    max_concurrency: int = 1
    is_async: bool = False
    lifetime: Optional[str] = None           # None | "detached"
    scheduling_strategy: Any = None
    creation_return_id: Optional[ObjectID] = None
    runtime_env: Optional[dict] = None       # validated runtime env


@dataclass
class PlacementGroupSpec:
    pg_id: PlacementGroupID
    bundles: List[Dict[str, float]] = field(default_factory=list)
    strategy: str = "PACK"                   # PACK|SPREAD|STRICT_PACK|STRICT_SPREAD
    name: str = ""


# --------------------------------------------------------------- connection
#
# Wire framing (v2):
#
#     frame := <u32 len> <u8 tag> <payload>       (len counts tag+payload)
#
#     tag 0 (plain): payload = pickle-5 stream, buffers in-band
#     tag 1 (oob):   payload = <u32 pkl_len> <u32 nbuf> <u64 len_0..n-1>
#                              <pickle stream> <buf_0> ... <buf_n-1>
#
# A tag-1 frame carries pickle protocol-5 out-of-band buffers: any
# ``PickleBuffer`` (and any buffer-protocol object that opts into
# protocol-5 out-of-band pickling, e.g. contiguous numpy arrays) of
# ``transport_oob_threshold_bytes`` or more is shipped as a raw iovec
# after the pickle stream instead of being copied into it. The decoder
# hands ``pickle.loads`` zero-copy memoryviews into the frame buffer,
# so a large payload is copied exactly once (socket -> frame buffer)
# before landing at its destination (arena block / shm segment).

_TAG_PLAIN = 0
_TAG_OOB = 1
_HDR = struct.Struct("<IB")          # frame length + tag
_OOB_HDR = struct.Struct("<II")      # pickle_len, nbuf
_U64 = struct.Struct("<Q")

# frames at/above this size are received into a dedicated buffer filled
# straight off the socket: one copy, and out-of-band views into it stay
# valid without a second materialization
_DEDICATED_RECV_MIN = 1 << 16
# single-frame sends up to this body size concatenate header+body and
# use one plain send: a sub-µs copy beats the extra-iovec sendmsg cost;
# bigger bodies ride as iovecs (the copy the old transport paid on
# EVERY frame is what this replaces)
_SMALL_CONCAT_MAX = 1 << 12
# iovecs per sendmsg call (IOV_MAX is 1024 on Linux; stay well under)
_MAX_IOV = 512
# close() flushes queued frames for at most this long before cutting
# the socket (a wedged peer must not hang teardown)
_CLOSE_DRAIN_TIMEOUT = 5.0


def oob_wrap(data):
    """Wrap a bytes-like payload so the transport ships it out-of-band
    (zero-copy iovec) when it clears the threshold; small payloads stay
    plain. The receiver sees a memoryview for wrapped payloads."""
    if data is not None and len(data) >= CONFIG.transport_oob_threshold_bytes:
        return pickle.PickleBuffer(data)
    return data


def fail_dropped_request(msg, exc: BaseException, lock, futures) -> None:
    """Shared ``Connection.on_send_error`` body for request/reply
    channels: when the transport drops a queued frame (encode failure
    on the drainer path), fail the pending future whose req_id the
    frame carried instead of letting its caller block forever.
    Requests are ``(op, (req_id, ...))`` by construction at every
    call site."""
    try:
        payload = msg[1]
        req_id = payload[0] if type(payload) is tuple and payload else None
    except Exception:
        return
    if not isinstance(req_id, int):
        return
    with lock:
        fut = futures.pop(req_id, None)
    if fut is not None and not fut.done():
        fut.set_exception(
            exc if isinstance(exc, Exception) else RuntimeError(str(exc)))


def _est_size(payload, depth: int = 3) -> int:
    """Cheap pre-pickle size estimate used to bound batch frames. Exact
    for the dominant large carriers (bytes-like leaves, PickleBuffers
    and ObjectMeta inlines); everything else counts a small constant.
    Depth 3 reaches the hottest shapes' payloads — a TASK_DONE /
    GET_REPLY message is ``(op, (id, [metas], ...))``, putting the
    metas three levels down. Long lists are sampled (first 16) and
    extrapolated so a burst of meta-carrying replies still respects
    ``transport_max_batch_bytes``."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return len(payload) + 32
    if isinstance(payload, pickle.PickleBuffer):
        try:
            return payload.raw().nbytes + 32
        except Exception:
            return 64
    if depth > 0 and isinstance(payload, (tuple, list)):
        n = len(payload)
        if n == 0:
            return 32
        est = sum(_est_size(v, depth - 1) for v in payload[:16])
        if n > 16:
            est = est * n // 16
        return 32 + est
    inline = getattr(payload, "inline", None)
    if inline is not None:
        return len(inline) + 128
    # numpy arrays (collective chunks) expose nbytes; without this a
    # burst of 512KB chunks would estimate as 64B each and coalesce
    # into one multi-MB BATCH frame
    nbytes = getattr(payload, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes + 64
    return 64


@fieldsan.guarded
class Connection:
    """Framed-message socket: batched, vectored, thread-safe sends
    through a per-connection writer thread; burst receives.

    ``send`` enqueues and returns; a lazily-started writer drains the
    queue the moment it is non-empty (opportunistic corking — no
    latency timers), packing every pending message into as few frames
    (small ones coalesce into one ``BATCH``) and as few ``sendmsg``
    syscalls as possible. The receive side decodes every complete frame
    per socket wakeup, so ``recv_many`` hands the dispatcher a whole
    burst at once.
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._sendmsg = getattr(sock, "sendmsg", None)
        self._qlock = locksan.lock("conn.queue")    # guards _outq + flags
        self._flush_lock = locksan.lock("conn.flush")  # the active drainer
        self._outq: "deque" = deque()
        self._broken = False            # socket died under a drainer
        self._closing = False
        self._recv_buf = bytearray()
        self._decoded: "deque" = deque()
        self._max_batch_msgs = max(1, CONFIG.transport_max_batch_msgs)
        self._max_batch_bytes = max(1 << 12, CONFIG.transport_max_batch_bytes)
        self._queue_depth = max(1, CONFIG.transport_queue_depth)
        self._oob_threshold = max(1, CONFIG.transport_oob_threshold_bytes)
        # flush stats, accumulated as plain ints on the (single-drainer)
        # flush path and published to telemetry every 64 flushes — the
        # single-message fast path must not pay shard locks per frame
        self._stat_flushes = 0
        self._stat_msgs = 0
        self._stat_bytes = 0
        self._stat_oob = 0
        # out-of-band views collected by _buffer_cb during one encode;
        # safe as instance state because encoding only happens under
        # _flush_lock (single drainer)
        self._oob_scratch: List[memoryview] = []
        # called with (msg, exc) when a queued message is dropped on the
        # drainer path (encode failure that cannot be raised to its
        # sender) — request/reply channels hook this to fail the pending
        # future the dropped request would otherwise hang forever
        self.on_send_error = None
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                            CONFIG.socket_send_buffer_bytes)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                            CONFIG.socket_recv_buffer_bytes)
        except OSError:
            pass

    # ------------------------------------------------------------- sending
    #
    # Combining drainer ("the writer"): the sending thread enqueues and
    # then tries to become the drainer. Uncontended sends go straight to
    # the socket with no handoff; when another thread is already mid-
    # ``sendmsg``, messages pile onto the queue and the active drainer
    # picks them ALL up in one coalesced batch before releasing — the
    # burst pays one pickle header + one syscall. Opportunistic corking
    # with zero added latency (no timers, no thread hop).

    def send(self, msg: Tuple[int, Any]) -> None:
        """Send one message. Uncontended sends (no active drainer,
        empty queue — the overwhelmingly common case) encode and write
        inline with zero queue/wakeup bookkeeping, so batching costs
        nothing when there is nothing to batch."""
        if not self._outq and self._flush_lock.acquire(blocking=False):
            try:
                # benign unlocked read: the flags only ever flip to
                # True, and a send that slips past lands on a dead
                # socket and raises from sendmsg anyway
                if self._broken or self._closing:
                    raise OSError("connection is closed")
                try:
                    self._send_one(msg, reraise=True)
                except (OSError, ValueError):
                    self._poison()
                    raise
                finally:
                    # strand-guard: a contended producer that saw our
                    # lock held returned expecting us to pick its
                    # messages up — runs even when OUR encode failed
                    # (the connection is healthy then; a poisoned
                    # socket cleared the queue already)
                    if not self._broken:
                        self._drain_holding()
            finally:
                self._flush_lock.release()
                if self._outq:
                    # an enqueue slipped in after our final check but
                    # before the release — drain it like any other
                    # producer
                    self._drain()
            return
        self._enqueue((msg,))
        self._drain()

    def send_many(self, msgs) -> None:
        """Queue several messages as one ordered burst, then flush."""
        if msgs:
            self._enqueue(tuple(msgs))
            self._drain()

    def send_lazy(self, msg: Tuple[int, Any]) -> None:
        """Enqueue WITHOUT draining: the message leaves on the next
        ``send``/``send_many``/``kick``/``flush`` (any of which drains
        the whole queue in order). Lets a sender coalesce a frame with
        ones it knows are coming — the caller owns bounding the hold
        (e.g. the worker's TASK_DONE kicker)."""
        self._enqueue((msg,))

    def kick(self) -> None:
        """Drain anything queued (no-op when empty): the flush half of
        ``send_lazy``."""
        self._drain()

    def _enqueue(self, msgs: tuple) -> None:
        with self._qlock:
            if self._broken or self._closing:
                raise OSError("connection is closed")
            self._outq.extend(msgs)
            over = len(self._outq) > self._queue_depth
        if over:
            # bounded queue: the producer becomes/waits-for the drainer
            # until the backlog is gone (a streamed multi-GB pull must
            # not buffer unbounded frames in memory)
            telemetry.counter_inc(telemetry.M_TRANSPORT_QUEUE_STALLS)
            self._drain(block=True)

    def _poison(self) -> None:
        """Socket died under a drainer: drop the backlog and poison
        future sends; the peer-death signal is the reader's EOF."""
        with self._qlock:
            self._broken = True
            self._outq.clear()

    def _drain_holding(self) -> None:
        """Drain the queue to empty. Caller holds ``_flush_lock``."""
        while self._outq:       # unlocked peek: misses are caught by
            with self._qlock:   # the post-release re-check in send()
                batch = list(self._outq)
                self._outq.clear()
                if not batch:
                    return
            try:
                self._write_batch(batch)
            except (OSError, ValueError):
                self._poison()
                raise

    def _drain(self, block: bool = False) -> None:
        while True:
            if not self._outq:
                return
            if not self._flush_lock.acquire(blocking=block):
                # an active drainer exists; it re-checks the queue after
                # releasing, so our messages cannot be stranded — but if
                # they are still queued once it released, loop and drain
                # them ourselves (covers the enqueue-after-final-check
                # race)
                if not block:
                    with self._qlock:
                        if self._outq and not self._flush_lock.locked():
                            continue
                    return
                continue
            try:
                self._drain_holding()
            finally:
                self._flush_lock.release()

    def flush(self, timeout: Optional[float] = 5.0) -> None:
        """Block until every message enqueued before this call reached
        the socket (or the connection died / the timeout expired).

        The delivery guarantee is ACQUIRING ``_flush_lock``, not
        observing an empty queue: a batch another drainer popped before
        this call only counts as written once that drainer releases —
        an empty ``_outq`` alone says nothing about frames mid-
        ``sendmsg`` in a foreign drainer."""
        deadline = (time.monotonic() + timeout) if timeout else None
        while not self._broken:
            remaining = 0.1
            if deadline is not None:
                remaining = min(0.1, deadline - time.monotonic())
                if remaining <= 0:
                    return
            if self._flush_lock.acquire(timeout=remaining):
                try:
                    try:
                        self._drain_holding()
                    except OSError:
                        return
                finally:
                    self._flush_lock.release()
                if not self._outq:
                    return

    def _send_one(self, msg, reraise: bool = False) -> None:
        """Single-message fast path: encode + vectored write with
        minimal bookkeeping (no chunk list, no grouping pass).

        ``reraise`` propagates encode failures to the caller — the
        uncontended ``send()`` path, where the sender is the thread
        that owns the message and a dropped frame would leave a
        request-reply future unresolved forever. The drainer/batch
        path keeps drop-with-traceback: there the encoding thread may
        not be the sender, and one bad payload must not poison the
        connection."""
        try:
            body = pickle.dumps(msg, protocol=5,
                                buffer_callback=self._buffer_cb)
        except Exception as exc:
            self._oob_scratch.clear()
            if reraise:
                raise
            self._drop_msg(msg, exc)
            return
        if self._oob_scratch:
            chunks: list = []
            oob = self._oob_frame(body, chunks)
            self._account(1, chunks, oob)
            self._sendv(chunks)
            return
        nbody = len(body)
        total = _HDR.size + nbody
        self._stat_flushes += 1
        self._stat_msgs += 1
        self._stat_bytes += total
        if self._stat_flushes >= 64:
            self._publish_stats()
        hdr = _HDR.pack(1 + nbody, _TAG_PLAIN)
        sendmsg = self._sendmsg
        if nbody <= _SMALL_CONCAT_MAX or sendmsg is None:
            self._sock.sendall(hdr + body)
            return
        sent = sendmsg((hdr, body))
        if sent < total:
            self._finish_partial([hdr, body], sent, total, sendmsg)

    def _drop_msg(self, msg, exc: BaseException) -> None:
        """A queued message failed to encode on the drainer path and
        cannot be raised to its sender (the drainer may be a different
        thread): log it, and give the owning channel a chance to fail
        the pending future a dropped request would otherwise hang."""
        traceback.print_exc(file=sys.stderr)
        cb = self.on_send_error
        if cb is not None:
            try:
                cb(msg, exc)
            except Exception:
                pass

    def _write_batch(self, batch: list) -> None:
        if len(batch) == 1:
            self._send_one(batch[0])
            return
        chunks = []
        oob_bytes = 0
        group: list = []
        group_est = 0

        def emit_group():
            nonlocal group, group_est, oob_bytes
            if not group:
                return
            msg = group[0] if len(group) == 1 else (BATCH, group)
            try:
                oob_bytes += self._encode_frame(msg, chunks)
            except Exception as exc:
                # one unpicklable payload must not poison its batchmates
                # (or the connection): retry one by one, dropping the
                # offender with a traceback + on_send_error
                if len(group) > 1:
                    for one in group:
                        try:
                            oob_bytes += self._encode_frame(one, chunks)
                        except Exception as one_exc:
                            self._drop_msg(one, one_exc)
                else:
                    self._drop_msg(group[0], exc)
            group = []
            group_est = 0

        for msg in batch:
            est = _est_size(msg)
            if group and (len(group) >= self._max_batch_msgs
                          or group_est + est > self._max_batch_bytes):
                emit_group()
            group.append(msg)
            group_est += est
        emit_group()
        if not chunks:
            return
        # a coalesced flush is the interesting signal: record it exactly
        telemetry.hist_observe(telemetry.M_TRANSPORT_FLUSH_FRAMES,
                               float(len(batch)))
        self._account(len(batch), chunks, oob_bytes)
        self._sendv(chunks)

    def _account(self, n_msgs: int, chunks: list, oob_bytes: int) -> None:
        """Accumulate flush stats as plain ints (we are the only
        drainer); publish to telemetry every 64 flushes."""
        self._stat_flushes += 1
        self._stat_msgs += n_msgs
        self._stat_bytes += sum(len(c) for c in chunks)
        self._stat_oob += oob_bytes
        if self._stat_flushes >= 64:
            self._publish_stats()

    def _publish_stats(self) -> None:
        flushes, msgs = self._stat_flushes, self._stat_msgs
        nbytes, oob = self._stat_bytes, self._stat_oob
        self._stat_flushes = self._stat_msgs = 0
        self._stat_bytes = self._stat_oob = 0
        telemetry.counter_inc(telemetry.M_TRANSPORT_SEND_BYTES,
                              float(nbytes))
        if oob:
            telemetry.counter_inc(telemetry.M_TRANSPORT_OOB_BYTES,
                                  float(oob))
        if msgs == flushes:
            # all-singles window: one aggregate observation keeps the
            # frames-per-flush histogram honest about uncoalesced load
            # without paying a shard lock per frame
            telemetry.hist_observe(telemetry.M_TRANSPORT_FLUSH_FRAMES, 1.0)

    def _buffer_cb(self, pb) -> bool:
        """pickle-5 buffer_callback: large contiguous buffers collect
        into _oob_scratch to ride out-of-band (bound method — no
        closure allocation per frame)."""
        try:
            view = pb.raw()
        except Exception:               # non-contiguous: in-band copy
            return True
        if view.nbytes < self._oob_threshold:
            return True                 # truthy => keep in-band
        self._oob_scratch.append(view)
        return False                    # falsy => ship out-of-band

    def _encode_frame(self, msg, chunks: list) -> int:
        """Append one frame's iovec chunks; returns out-of-band bytes."""
        try:
            body = pickle.dumps(msg, protocol=5,
                                buffer_callback=self._buffer_cb)
        except Exception:
            self._oob_scratch.clear()
            raise
        if not self._oob_scratch:
            chunks.append(_HDR.pack(1 + len(body), _TAG_PLAIN))
            chunks.append(body)
            return 0
        return self._oob_frame(body, chunks)

    def _oob_frame(self, body: bytes, chunks: list) -> int:
        """Append a tag-1 frame carrying _oob_scratch as iovecs."""
        buffers = list(self._oob_scratch)
        self._oob_scratch.clear()
        oob = 0
        lens = bytearray()
        for v in buffers:
            lens += _U64.pack(v.nbytes)
            oob += v.nbytes
        total = 1 + _OOB_HDR.size + len(lens) + len(body) + oob
        chunks.append(_HDR.pack(total, _TAG_OOB)
                      + _OOB_HDR.pack(len(body), len(buffers)) + lens)
        chunks.append(body)
        chunks.extend(buffers)
        return oob

    def _sendv(self, chunks: list) -> None:
        """Vectored send of every chunk, handling partial writes."""
        sendmsg = self._sendmsg
        if sendmsg is None:             # pragma: no cover - non-Linux
            for c in chunks:
                self._sock.sendall(c)
            return
        i = 0
        n = len(chunks)
        while i < n:
            if i == 0 and n <= _MAX_IOV:
                group = chunks          # common case: no slice copy
            else:
                group = chunks[i:i + _MAX_IOV]
            i += len(group)
            total = sum(len(c) for c in group)
            sent = sendmsg(group)
            if sent < total:
                self._finish_partial(list(group), sent, total, sendmsg)

    @staticmethod
    def _finish_partial(group: list, sent: int, total: int,
                        sendmsg) -> None:
        """Resend the unsent tail after a short ``sendmsg`` (kernel
        buffer filled mid-frame)."""
        while sent < total:
            total -= sent
            j = 0
            while sent >= len(group[j]):
                sent -= len(group[j])
                j += 1
            if sent:
                group = [memoryview(group[j])[sent:]] + group[j + 1:]
            else:
                group = group[j:]
            sent = sendmsg(group)

    # ----------------------------------------------------------- receiving
    def recv(self) -> Optional[Tuple[int, Any]]:
        """Blocking receive of one message; None on EOF."""
        if not self._decoded and not self._fill_decoded():
            return None
        return self._decoded.popleft()

    def recv_many(self) -> Optional[List[Tuple[int, Any]]]:
        """Blocking receive of every already-decodable message (>= 1);
        None on EOF. One socket wakeup hands the caller a whole burst."""
        if not self._decoded and not self._fill_decoded():
            return None
        out = list(self._decoded)
        self._decoded.clear()
        if len(out) > 1:
            telemetry.hist_observe(telemetry.M_TRANSPORT_RECV_FRAMES,
                                   float(len(out)))
        return out

    def _fill_decoded(self) -> bool:
        """Read + decode until at least one message is ready. All frames
        already buffered decode in one pass (multi-frame decoder)."""
        out = self._decoded
        rb = self._recv_buf
        while not out:
            # decode every complete frame in the shared buffer; compact
            # once per pass instead of copying per read
            pos = 0
            end = len(rb)
            if end >= _HDR.size:
                mv = memoryview(rb)
                try:
                    while end - pos >= _HDR.size:
                        length, tag = _HDR.unpack_from(rb, pos)
                        if length < 1:
                            return False        # corrupt stream
                        if end - pos - _HDR.size < length - 1:
                            break
                        body = mv[pos + _HDR.size:
                                  pos + _HDR.size + length - 1]
                        try:
                            self._decode_body(tag, body, out, owned=False)
                        finally:
                            body.release()
                        pos += _HDR.size + length - 1
                finally:
                    mv.release()
                if pos:
                    del rb[:pos]
                    if out:
                        return True
            # a large incomplete frame is read straight into a dedicated
            # buffer: one copy off the socket, and out-of-band views
            # into it stay valid with no re-materialization
            if len(rb) >= _HDR.size:
                length, tag = _HDR.unpack_from(rb, 0)
                if length - 1 >= _DEDICATED_RECV_MIN:
                    body = bytearray(length - 1)
                    have = len(rb) - _HDR.size
                    body[:have] = memoryview(rb)[_HDR.size:]
                    del rb[:]
                    if not self._recv_into(memoryview(body)[have:]):
                        return False
                    self._decode_body(tag, memoryview(body), out,
                                      owned=True)
                    continue
            try:
                # modest read size: CPython allocates the full bufsize
                # per recv() call, so a large constant here pays an
                # allocation + page-fault tax on every wakeup
                chunk = self._sock.recv(1 << 16)
            except (ConnectionResetError, OSError):
                return False
            if not chunk:
                return False
            rb += chunk
        return True

    def _recv_into(self, view: memoryview) -> bool:
        while view.nbytes:
            try:
                n = self._sock.recv_into(view)
            except (ConnectionResetError, OSError):
                return False
            if not n:
                return False
            view = view[n:]
        return True

    def _decode_body(self, tag: int, body: memoryview, out: deque,
                     owned: bool) -> None:
        if tag == _TAG_PLAIN:
            msg = pickle.loads(body)
        else:
            if not owned:
                # out-of-band views must outlive the shared recv buffer
                body = memoryview(bytearray(body))
            pkl_len, nbuf = _OOB_HDR.unpack_from(body, 0)
            off = _OOB_HDR.size + nbuf * _U64.size
            pkl = body[off:off + pkl_len]
            off += pkl_len
            bufs = []
            for i in range(nbuf):
                (blen,) = _U64.unpack_from(body,
                                           _OOB_HDR.size + i * _U64.size)
                bufs.append(body[off:off + blen])
                off += blen
            msg = pickle.loads(pkl, buffers=bufs)
        if type(msg) is tuple and msg and msg[0] == BATCH:
            out.extend(msg[1])
        else:
            out.append(msg)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        with self._qlock:
            self._closing = True
        # drain what was queued before the close (a side-effecting frame
        # sent just before shutdown must still reach the peer) — but
        # bounded: a wedged peer that stopped reading leaves the socket
        # buffer full, and teardown must not hang on it. The shutdown()
        # below also errors out a foreign drainer stuck mid-send, which
        # is what unblocked a stuck sendall in the pre-batching
        # transport.
        try:
            self._sock.settimeout(_CLOSE_DRAIN_TIMEOUT)
        except OSError:
            pass
        if self._flush_lock.acquire(timeout=_CLOSE_DRAIN_TIMEOUT):
            try:
                self._drain_holding()
            except OSError:
                pass
            finally:
                self._flush_lock.release()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


def connect_unix(path: str, timeout: float = 30.0) -> Connection:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    sock.connect(path)
    sock.settimeout(None)
    return Connection(sock)


def connect_tcp(host: str, port: int, timeout: float = 30.0) -> Connection:
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return Connection(sock)


def connect_address(address: str, timeout: float = 30.0) -> Connection:
    """Connect to ``host:port`` (TCP) or a filesystem path (unix)."""
    if ":" in address and not address.startswith("/"):
        host, port = address.rsplit(":", 1)
        return connect_tcp(host, int(port), timeout)
    return connect_unix(address, timeout)


def listen_tcp(host: str = "0.0.0.0", port: int = 0) -> socket.socket:
    """Bound+listening TCP socket; port 0 picks a free port (read it back
    via ``sock.getsockname()[1]``)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(128)
    return sock
