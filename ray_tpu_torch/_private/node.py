"""Per-node service: scheduler, worker pool, object directory, actor manager.

Equivalent role to the reference's raylet (``src/ray/raylet/node_manager.h:125``
— worker leasing, dependency management, dispatch) fused with the
owner-side core-worker duties (``core_worker/task_manager.h:173`` — retries,
``object_recovery_manager.h`` — failure handling). One service per node; a
single dispatcher thread owns all mutable state (the reference gets the same
discipline from its asio event loop); per-connection reader threads feed a
queue. Workers are real OS processes talking framed messages over a unix
socket; object payloads ride shared memory (``object_store.py``).
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from .. import exceptions
from . import events
from . import fieldsan
from . import history as history_mod
from . import locksan
from . import memory_monitor
from . import protocol as P
from . import scheduler as sched
from . import telemetry
from .config import CONFIG
from .gcs import (ACTOR_ALIVE, ACTOR_DEAD, ACTOR_PENDING, ACTOR_RESTARTING,
                  GlobalControlPlane, NodeInfo, PG_LOST, TaskEvent)
from .ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from . import object_store
from .object_store import ObjectMeta, ObjectStore
from .rpc import RpcChannel
from .serialization import to_bytes

_WORKER_STATES = ("STARTING", "IDLE", "BUSY", "ACTOR", "DEAD")


@dataclass
class _Worker:
    worker_id: WorkerID
    proc: Optional[subprocess.Popen] = None
    conn: Optional[P.Connection] = None
    conn_key: Optional[int] = None
    state: str = "STARTING"
    task: Optional["_TaskRecord"] = None
    # same-shape tasks leased to this worker beyond the running one
    # (reference: worker-lease reuse — the owner pushes tasks to a
    # leased worker without a per-task raylet round trip,
    # ``lease_policy.h`` / ``direct_task_transport.h``). Only the
    # running task holds the resource charge; the charge transfers on
    # each completion since every piped task has the identical shape.
    pipeline: "deque" = field(default_factory=deque)
    # monotonic per-worker lease grant counter: every EXECUTE pushed to
    # this worker (assignment or pipelined lease) carries the next seq,
    # and the worker echoes it on RETURN_LEASED — a rescue that names a
    # superseded grant is provably stale and is dropped instead of
    # un-assigning whatever the task's CURRENT grant is (the sequenced
    # handshake that made pipelining default-on; reference analogue:
    # lease ids in ``direct_task_transport.h``)
    lease_seq: int = 0
    actor_id: Optional[ActorID] = None
    started_at: float = field(default_factory=time.monotonic)
    # when the current task/actor work was assigned — pooled workers are
    # reused, so the OOM RetriableLIFO must rank by work recency, not
    # process age
    assigned_at: float = 0.0
    # runtime-env pool key (reference: WorkerPool keyed by runtime env,
    # ``worker_pool.h:152``); "" = the default environment
    env_key: str = ""
    idle_since: float = 0.0
    log_path: Optional[str] = None
    # human name for log attribution (SET_LOG_LABEL — e.g. a serve
    # replica's "deployment#tag"); rides every published LOG batch so
    # driver-side prefixes are greppable by deployment
    log_label: Optional[str] = None
    # set just before the memory monitor kills the process, so the
    # conn-closed path reports OutOfMemoryError rather than a crash
    oom_victim: bool = False
    # OS pid from the REGISTER handshake, for workers this node did not
    # spawn itself (proc is None for those)
    pid: Optional[int] = None
    # threads of this process currently parked in a blocking get(),
    # whether or not the running record holds a CPU charge (an ACTOR
    # method's record doesn't — the creation does). Workers counted
    # here are exempt from the pool cap: an actor blocked on a nested
    # actor creation (e.g. a collective-group coordinator) would
    # otherwise deadlock a full pool that only it can unblock
    blocked_gets: int = 0
    # registration deadline override (pip-env workers build a venv before
    # they can register; 0 = plain CONFIG.worker_register_timeout_s)
    register_timeout_s: float = 0.0
    # True while the spawn includes a runtime-env build: a
    # killed-at-deadline then counts as an ENV failure (the build hung),
    # not as load
    env_setup: bool = False


@dataclass
class _TaskRecord:
    spec: P.TaskSpec
    kind: str = "task"                    # task | actor_create | actor_call
    deps: Dict[ObjectID, ObjectMeta] = field(default_factory=dict)
    remaining_deps: Set[ObjectID] = field(default_factory=set)
    retries_left: int = 0
    # OOM kills are budgeted separately from task failures (reference:
    # task_oom_retries) — transient memory pressure shouldn't consume
    # the user's max_retries
    oom_retries_left: int = 0
    worker_id: Optional[WorkerID] = None
    charge: Optional[Dict[str, float]] = None
    pg_key: Optional[tuple] = None
    actor_spec: Optional[P.ActorSpec] = None
    cancelled: bool = False
    # stores actually pinned at dispatch, so unpin hits the same store
    # even if the object's directory entry changes mid-task
    pinned_stores: Dict[ObjectID, Any] = field(default_factory=dict)
    # count of worker threads currently blocked in a get(); the CPU
    # charge is returned to the pool while > 0 (a bool would mispair
    # when a task's user threads block concurrently — the first
    # unblock would re-charge while others still wait)
    blocked_depth: int = 0
    # when this record entered the local pending queue — a task starved
    # here past the spillback delay gets re-routed if capacity opened
    # elsewhere
    queued_at: float = field(default_factory=time.monotonic)
    # exclusive GPU slot indices held while running (whole-card demands)
    accel_ids: Optional[List[int]] = None
    # the slots a worker was started (or is alive) for on this task's
    # behalf: taken again while all are free, so the task waits for that
    # worker rather than take lower slots another task has just freed
    want_gpus: Optional[List[int]] = None
    # True once a worker handed this lease back (it sat behind a
    # blocking task): never pipe it again — one bounce max per task,
    # so rescue storms terminate and normal scheduling takes over
    no_pipe: bool = False
    # seq of the grant currently dispatching this task (see
    # _Worker.lease_seq); a RETURN_LEASED naming any other seq is stale
    lease_seq: int = 0



_PIPE_DEBUG = os.environ.get("RTPU_PIPE_DEBUG") == "1"


def _pdbg(msg):
    if _PIPE_DEBUG:
        print(f"[pipe {os.getpid()} {time.monotonic():.3f}] {msg}",
              file=sys.stderr, flush=True)

@fieldsan.guarded
class _PendingQueue:
    """Ready-to-dispatch tasks bucketed by scheduling shape
    (pg, resources, env).

    Dispatch cost per event is O(#distinct shapes + #assigned) instead
    of O(#pending): a shape that fails to fit blocks only its own
    bucket, and a 10k-task burst of one shape is a single head probe —
    the flat-deque scan made every completion O(pending) and bursts
    O(pending²) (reference analogue: schedulable-queue buckets per
    resource shape, ``cluster_task_manager.cc``)."""

    def __init__(self, env_key_fn):
        self._by_shape: Dict[tuple, deque] = {}
        self._env_key_fn = env_key_fn
        self._n = 0
        self._seq = 0

    def append(self, rec: "_TaskRecord") -> None:
        shape = (rec.pg_key,
                 tuple(sorted(rec.spec.resources.items())),
                 self._env_key_fn(rec))
        rec._pending_shape = shape
        self._seq += 1
        rec._pending_seq = self._seq
        q = self._by_shape.get(shape)
        if q is None:
            q = self._by_shape[shape] = deque()
        q.append(rec)
        self._n += 1

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        for q in list(self._by_shape.values()):
            yield from q

    def shapes(self) -> list:
        """Shapes ordered by their OLDEST member, so freed capacity goes
        to the longest-waiting task first (global-FIFO-like fairness —
        a continuously fed bucket must not starve the others)."""
        return sorted(
            (s for s, q in self._by_shape.items() if q),
            key=lambda s: self._by_shape[s][0]._pending_seq)

    def bucket(self, shape) -> deque:
        return self._by_shape.get(shape) or deque()

    def popleft(self, shape) -> "_TaskRecord":
        rec = self._by_shape[shape].popleft()
        self._n -= 1
        return rec

    def remove(self, rec: "_TaskRecord") -> bool:
        """Purge a (cancelled) record wherever it sits in its bucket."""
        shape = getattr(rec, "_pending_shape", None)
        q = self._by_shape.get(shape)
        if q is None:
            return False
        try:
            q.remove(rec)
        except ValueError:
            return False
        self._n -= 1
        if not q:
            del self._by_shape[shape]
        return True

    def drop_empty(self, shape) -> None:
        q = self._by_shape.get(shape)
        if q is not None and not q:
            del self._by_shape[shape]


@dataclass
class _OwnedTask:
    """Owner-side record of a submitted task, for retry on node failure.

    Reference analogue: ``TaskManager`` lineage entries
    (``core_worker/task_manager.h:369`` RetryTaskIfPossible).
    """

    spec: P.TaskSpec
    kind: str
    retries_left: int
    assigned_node: Optional[NodeID] = None
    actor_spec: Optional[P.ActorSpec] = None
    done: bool = False


@dataclass
class _Waiter:
    req_id: int
    conn_key: int
    object_ids: List[ObjectID]
    remaining: Set[ObjectID] = field(default_factory=set)
    num_returns: int = 0                  # for WAIT; 0 means GET (need all)
    timer: Optional[threading.Timer] = None
    fired: bool = False
    # cross-host driver GET: inline payload bytes into the reply metas
    fetch: bool = False
    # registration time + next-probe stamp/backoff for the tick's
    # stalled-waiter rescue (fruitless probes back off exponentially so
    # waiters on genuinely still-running producers don't cost a plane
    # lookup per oid per tick)
    born: float = field(default_factory=time.monotonic)
    probe_at: float = field(default_factory=lambda: time.monotonic() + 1.0)
    probe_backoff: float = 1.0


class _RemotePeer:
    """Handle to a node service in another OS process (network plane).

    Carries the cross-node surface ``NodeService`` uses on its peers:
    task/actor forwarding (``post_remote``), the object plane
    (``get_meta``/``pin_and_get``/``unpin``) and PG bundle reservation.
    Same-host peers exchange objects by shm name (zero-copy through
    /dev/shm); cross-host peers pull payload bytes and adopt a local
    secondary copy (reference: ``object_manager.h:117`` Push/Pull).
    Requests are answered on the peer's connection-reader thread, never
    its dispatcher, so two nodes calling into each other cannot
    deadlock."""

    def __init__(self, node: "NodeService", info):
        self.node = node
        self.node_id = info.node_id
        self.same_host = bool(info.host) and info.host == node.host
        self._chan = RpcChannel(P.connect_address(info.address, timeout=10.0))
        self._timeout = CONFIG.worker_lease_timeout_s
        self.dead = False

    @property
    def closed(self) -> bool:
        return self._chan.closed

    def close(self) -> None:
        self._chan.close()

    def post_remote(self, item: tuple) -> None:
        try:
            self._chan.send(P.NODE_POST, item)
        except OSError:
            pass

    # ----- object plane (duck-types the ObjectStore read surface)
    def get_meta(self, oid: ObjectID) -> Optional[ObjectMeta]:
        try:
            if self.same_host:
                return self._chan.request(
                    P.OBJ_GET_META, lambda r: (r, oid, False),
                    timeout=self._timeout)
            return self._pull(oid, pin=False)
        except Exception:
            return None

    def pin_and_get(self, oid: ObjectID) -> Optional[ObjectMeta]:
        try:
            if self.same_host:
                return self._chan.request(
                    P.OBJ_GET_META, lambda r: (r, oid, True),
                    timeout=self._timeout)
            return self._pull(oid, pin=True)
        except Exception:
            return None

    def unpin(self, oid: ObjectID) -> None:
        if self.same_host:
            try:
                self._chan.send(P.OBJ_UNPIN, oid)
            except OSError:
                pass
        else:
            self.node.store.unpin(oid)

    def _pull(self, oid: ObjectID, pin: bool) -> Optional[ObjectMeta]:
        store = self.node.store
        if store.contains(oid):
            return store.pin_and_get(oid) if pin else store.get_meta(oid)
        # chunked pull (reference: object_manager.h:117): the first chunk
        # also carries the owner's meta, so small objects cost one RTT
        # and large ones stream in bounded frames instead of one
        # payload-sized message
        chunk = CONFIG.object_transfer_chunk_bytes
        res = self._chan.request(
            P.OBJ_PULL_CHUNK, lambda r: (r, oid, 0, chunk),
            timeout=self._timeout)
        if res is None:
            return None
        meta, data = res
        if data is None:
            return meta          # inline / error values travel in the meta
        if meta.size <= len(data):
            store.adopt_payload(oid, data)
        else:
            writer = store.adopt_begin(oid, meta.size)
            try:
                writer.write(0, data)
                # windowed stream (reference: object_manager keeps
                # several chunks in flight): overlap RTTs instead of
                # paying one per chunk serially
                offsets = deque(range(len(data), meta.size, chunk))
                window: deque = deque()
                def issue():
                    off = offsets.popleft()
                    window.append((off, self._chan.request_async(
                        P.OBJ_PULL_CHUNK,
                        lambda r, off=off: (r, oid, off, chunk))))
                for _ in range(min(4, len(offsets))):
                    issue()
                while window:
                    off, fut = window.popleft()
                    res = fut.result(timeout=self._timeout)
                    if res is None or res[1] is None or not res[1]:
                        writer.abort()   # owner lost/evicted it mid-stream
                        return None
                    writer.write(off, res[1])
                    if offsets:
                        issue()
            except BaseException:
                writer.abort()
                raise
            writer.finish()
        return store.pin_and_get(oid) if pin else store.get_meta(oid)

    # ----- placement groups
    def reserve_bundle(self, pg_key: tuple, demand: Dict[str, float]) -> bool:
        try:
            return bool(self._chan.request(
                P.PG_RESERVE, lambda r: (r, pg_key, demand),
                timeout=self._timeout))
        except Exception:
            return False

    def release_bundle(self, pg_key: tuple) -> None:
        try:
            self._chan.send(P.PG_RELEASE, pg_key)
        except OSError:
            pass

    def peek(self, oid: ObjectID) -> Optional[ObjectMeta]:
        """Metadata-only existence probe: never transfers the payload
        (a cross-host wait() on a huge object must not download it)."""
        try:
            return self._chan.request(P.OBJ_GET_META,
                                      lambda r: (r, oid, False),
                                      timeout=self._timeout)
        except Exception:
            return None

    def node_stats(self, what, timeout: Optional[float] = None) -> Any:
        # debug collections ("stacks"/"profile" tuples) pass their own
        # timeout: a profile's duration can exceed the lease timeout
        try:
            return self._chan.request(P.NODE_STATS, lambda r: (r, what),
                                      timeout=timeout or self._timeout)
        except Exception:
            return None

    def coll_forward(self, body: tuple) -> None:
        """Forward one collective chunk to this peer's node, which
        delivers it to the destination process (fire and forget — a
        lost chunk surfaces as the receiving rank's deadline)."""
        try:
            self._chan.send(P.COLL_FWD, body)
        except OSError:
            pass


@fieldsan.guarded
class NodeService:
    """One per node. ``head=True`` also hosts the control plane."""

    def __init__(self, gcs: GlobalControlPlane, session_dir: str,
                 resources: Dict[str, float], node_id: Optional[NodeID] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.gcs = gcs
        self.node_id = node_id or NodeID.from_random()
        self.session_dir = session_dir
        os.makedirs(session_dir, exist_ok=True)
        self.socket_path = os.path.join(
            session_dir, f"node_{self.node_id.hex()[:12]}.sock")
        self.store = ObjectStore(
            spill_dir=os.path.join(session_dir, "spill", self.node_id.hex()[:12]))

        self._res_lock = locksan.lock("node.res")
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        self.pg_reservations: Dict[tuple, Dict[str, float]] = {}
        self.pg_bundle_total: Dict[tuple, Dict[str, float]] = {}

        self._events: "queue.SimpleQueue" = queue.SimpleQueue()
        self._conns: Dict[int, P.Connection] = {}
        self._conn_kind: Dict[int, int] = {}
        self._conn_worker: Dict[int, WorkerID] = {}
        # collective data plane routing: worker-id binary -> conn, for
        # every registered process (workers AND drivers — a driver can
        # be a collective rank). Written on the dispatcher (REGISTER /
        # conn_closed), read on reader threads; dict ops are atomic.
        self._coll_conns: Dict[bytes, P.Connection] = {}
        self._conn_coll_wid: Dict[int, bytes] = {}
        # node-id binary -> resolved peer handle for chunk forwarding:
        # _peer() starts with a gcs.get_node (an RPC on non-head nodes)
        # and the chunk plane must not pay a control-plane round trip
        # per chunk; entries are revalidated by their own closed/dead
        # flags, so a restarted peer re-resolves on first failure
        self._coll_peers: Dict[bytes, Any] = {}
        # conn keys are minted on BOTH accept threads (unix + tcp):
        # itertools.count.__next__ is GIL-atomic, where the former
        # `key = n; n += 1` could mint the same key on both threads
        # and alias two connections in _conns (found by the
        # guarded-by audit)
        self._conn_keys = itertools.count(1)
        self._workers: Dict[WorkerID, _Worker] = {}
        self._idle: deque = deque()
        self._num_starting = 0
        self._max_workers = max(int(resources.get("CPU", 4)) * 2, 8)
        # consecutive startup failures per env_key; after
        # CONFIG.worker_startup_max_failures, pending tasks needing that
        # env fail fast instead of respawning forever (reference:
        # PopWorker failure callback, ``worker_pool.h:152``)
        self._env_spawn_failures: Dict[str, int] = {}
        self._env_spawn_error: Dict[str, str] = {}

        # versioned resource sync state (RaySyncer-equivalent): a
        # time-epoch base keeps versions monotonic across a node-process
        # restart under the same id
        self._resource_version = int(time.time() * 1000)
        self._last_hb_at = 0.0
        self._hb_count = 0
        self._last_hb_snapshot: Optional[Dict[str, float]] = None
        self._last_hb_pending: Optional[list] = None
        self._pending = _PendingQueue(self._rec_env_key)  # ready-to-dispatch
        # per-worker EXECUTE outbox: sends coalesce across one event
        # (a SUBMIT_BATCH of 100 tiny tasks becomes one frame per
        # worker, not 100); flushed at the end of every dispatcher
        # event by _dispatch_loop
        self._exec_outbox: Dict[WorkerID, List[tuple]] = {}
        # per-connection reply outbox (dispatcher-thread replies only):
        # GET/WAIT replies coalesce across one event batch into one
        # frame per client — see _reply_batched
        self._reply_outbox: Dict[int, List[tuple]] = {}
        # True while draining a SUBMIT_BATCH: _queue_local defers its
        # per-spec _dispatch so the burst is one scheduling pass
        self._in_batch = False
        # resources routed to a peer but not yet visible in its gossiped
        # availability: {node_id: [(monotonic_ts, resources,
        # resource_version_at_debit), ...]}. Subtracted from _candidates
        # so a burst doesn't pile onto one node through a stale view
        # (RaySyncer-staleness bridge); a debit expires when the peer
        # gossips a NEWER snapshot (version advance) or at the TTL.
        self._route_debits: Dict[NodeID, List[tuple]] = {}
        # last gossiped resource_version per node (stamped by
        # _candidates, consumed by _debit_route)
        self._node_versions: Dict[NodeID, int] = {}
        # where each task WE submitted ran, outliving the _owned entry
        # (popped at completion): the read path probes this node's
        # store before asking the head's directory (owner-based
        # location resolution, reference:
        # ownership_based_object_directory.h). Bounded FIFO.
        self._task_origin: "OrderedDict[TaskID, NodeID]" = OrderedDict()
        self._waiting_deps: Dict[TaskID, _TaskRecord] = {}
        self._dep_index: Dict[ObjectID, Set[TaskID]] = {}
        self._running: Dict[TaskID, _TaskRecord] = {}
        self._owned: Dict[TaskID, _OwnedTask] = {}

        self._actors: Dict[ActorID, dict] = {}            # local actor state
        self._actor_queues: Dict[ActorID, deque] = {}
        # owners with a dep-waiting call in flight per actor: later calls
        # from the same owner must NOT overtake it — actor tasks execute
        # in per-submitter order (reference: actor_scheduling_queue.cc
        # sequence numbers); other owners' calls may interleave freely
        self._actor_blocked_owners: Dict[ActorID, set] = {}

        self._get_waiters: Dict[int, _Waiter] = {}
        self._wait_waiters: Dict[int, _Waiter] = {}
        # parked GEN_NEXT requests: {(task_id, index): [(conn_key,
        # req_id), ...]} — resolved when the item seals or the stream
        # ends short of the index
        self._gen_waiters: Dict[tuple, List[Tuple[int, int]]] = {}
        # last-known consumer credit per stream (from GEN events): a
        # consumed/close that lands BEFORE the producer task starts here
        # must still reach the worker — relayed on its first GEN_ITEM
        self._gen_consumed_cache: Dict[Any, int] = {}
        # node-local stream records for streaming tasks that ran here:
        # produced/done counters answered without the head (reference:
        # generator state is owner-hosted, core_worker.proto:396)
        self._gen_local: Dict[Any, dict] = {}
        self._obj_waiter_index: Dict[ObjectID, Set[int]] = {}
        self._next_waiter = 1

        self._stopped = threading.Event()
        self._threads: List[threading.Thread] = []
        self._listener: Optional[socket.socket] = None
        self._tcp_listener: Optional[socket.socket] = None
        self.tcp_address: Optional[str] = None
        self._driver_conn_keys: Set[int] = set()
        self.dead = False

        # OS-host identity for the object plane (same host = shared
        # /dev/shm); overridable to simulate cross-host transfer in tests
        self.host = os.environ.get("RTPU_NODE_HOST") or socket.gethostname()
        self._peers: Dict[NodeID, _RemotePeer] = {}

        # reference counting: objects each client connection holds (edge
        # transitions forwarded to the control plane), and in-flight
        # lineage reconstructions (reference: reference_count.h:61 +
        # object_recovery_manager.h:90)
        self._conn_refs: Dict[int, Set[ObjectID]] = {}
        self._reconstructing: Set[ObjectID] = set()

        # tasks/actors with no feasible node, parked while the
        # autoscaler adds capacity (reference: infeasible task queue,
        # ``cluster_task_manager.cc``); (deadline, kind, spec)
        self._infeasible: List[tuple] = []
        # set while re-routing a parked item so a repeat park keeps the
        # ORIGINAL deadline (the grace window must not reset under churn)
        self._repark_deadline: Optional[float] = None

        self._memory_monitor = memory_monitor.MemoryMonitor()
        self._last_mem_check = 0.0

        # per-instance GPU slots (reference: resource-instance ids):
        # whole-card demands get exclusive indices, lowest first, so a
        # task charged, released and charged again gets the same cards
        # (and the idle worker bound to them, see _worker_key);
        # fractional shares are capacity-only
        self._gpu_free: List[int] = list(
            range(int(self.resources_total.get("GPU", 0))))

        # set in start() when a TCP plane exists (see the probe comment)
        self.shm_probe_path: Optional[str] = None
        self.shm_probe_token: Optional[str] = None

        # actor calls parked while their actor is between nodes
        # (node-death reroute window; see _submit_actor_task)
        self._reroute_parked: Dict[ActorID, List[P.TaskSpec]] = {}

        # structured lifecycle events (reference: src/ray/util/event.h)
        self.events = events.EventLogger(session_dir, self.node_id.hex(),
                                         gcs=gcs)

        # in-flight debug collections (stack dumps / profiles): token ->
        # Future resolved by STACK_REPLY/PROFILE_REPORT on the replying
        # connection's reader thread — never the dispatcher, so a stack
        # request cannot deadlock against task handling
        self._debug_lock = locksan.lock("node.debug")
        self._debug_futures: Dict[int, Future] = {}
        self._next_debug_token = 1
        # short-TTL cache of the last collective-health report: one dead
        # rank makes every survivor diagnose near-simultaneously, and W
        # identical cluster-wide fan-outs at the exact moment the
        # cluster is wedged would be a thundering herd
        self._coll_health_cache: Tuple[float, Optional[dict]] = (0.0,
                                                                 None)

        self._rng = random.Random(self.node_id.binary())

        # pre-built telemetry tag tuple: the record path is hot (every
        # submit/dispatch/seal), so the tags must not be rebuilt per call
        self._mtags = (("node", self.node_id.hex()[:12]),)

    # ----------------------------------------------------------- lifecycle
    def start(self, labels: Optional[Dict[str, str]] = None,
              tcp_port: Optional[int] = None,
              advertise_host: str = "127.0.0.1") -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(128)
        if tcp_port is not None:
            # network plane: peers/drivers in other OS processes connect
            # here; the unix socket stays the local worker fast path
            self._tcp_listener = P.listen_tcp(port=tcp_port)
            self.tcp_address = (
                f"{advertise_host}:{self._tcp_listener.getsockname()[1]}")
            # Shared-memory capability probe: a driver that can read this
            # token back shares our /dev/shm and may use the shm data
            # plane; one that can't must ship payloads over the socket.
            # A direct probe beats hostname comparison (containers often
            # share names across machines).
            self.shm_probe_path = f"/dev/shm/rtpt_probe_{self.node_id.hex()[:12]}"
            self.shm_probe_token = os.urandom(8).hex()
            try:
                with open(self.shm_probe_path, "w") as f:
                    f.write(self.shm_probe_token)
            except OSError:
                self.shm_probe_path = None
        self.gcs.register_node(NodeInfo(
            node_id=self.node_id,
            address=self.tcp_address or self.socket_path,
            resources_total=dict(self.resources_total),
            labels=labels or {}, service=self, host=self.host,
            resources_available=dict(self.resources_total)))
        self.gcs.subscribe("OBJECT", self._on_object_published)
        self.gcs.subscribe("NODE", self._on_node_event)
        self.gcs.subscribe("TASK_FINISHED", self._on_task_finished)
        self.gcs.subscribe("ACTOR", self._on_actor_event)
        self.gcs.subscribe("REF_ZERO", self._on_ref_zero)
        self.gcs.subscribe("LOG", self._on_log_event)
        self.gcs.subscribe("GEN", self._on_gen_published)
        if CONFIG.log_to_driver:
            t_logs = threading.Thread(
                target=self._log_tail_loop,
                name=f"rtpu-logs-{self.node_id.hex()[:6]}", daemon=True)
            t_logs.start()
            self._threads.append(t_logs)
        t_acc = threading.Thread(target=self._accept_loop,
                                 args=(self._listener,),
                                 name=f"rtpu-accept-{self.node_id.hex()[:6]}",
                                 daemon=True)
        t_disp = threading.Thread(target=self._dispatch_loop,
                                  name=f"rtpu-dispatch-{self.node_id.hex()[:6]}",
                                  daemon=True)
        if self._tcp_listener is not None:
            t_tcp = threading.Thread(
                target=self._accept_loop, args=(self._tcp_listener,),
                name=f"rtpu-accept-tcp-{self.node_id.hex()[:6]}", daemon=True)
            t_tcp.start()
            self._threads.append(t_tcp)
        t_acc.start()
        t_disp.start()
        # Periodic tick: the dispatch loop otherwise only wakes on events,
        # so a worker that dies before ever connecting (e.g. a broken
        # runtime env) would leave its pending task asleep forever.
        t_tick = threading.Thread(target=self._tick_loop,
                                  name=f"rtpu-tick-{self.node_id.hex()[:6]}",
                                  daemon=True)
        t_tick.start()
        self._threads += [t_acc, t_disp, t_tick]
        # warm pool: spawning lazily on the first task burst serializes
        # behind worker cold-start (reference prestarts too,
        # ``worker_pool.h`` PrestartWorkers)
        n_pre = (CONFIG.num_prestart_workers
                 or int(self.resources_total.get("CPU", 0)))
        n_pre = max(0, min(n_pre, self._max_workers,
                           # leave startup-concurrency headroom so a
                           # runtime-env spawn isn't stuck behind the wave
                           CONFIG.maximum_startup_concurrency - 2))
        if n_pre:
            # Spawn ON the dispatcher thread: _spawn_worker mutates
            # dispatcher-owned state (_workers/_idle/_num_starting), and
            # the dispatcher is already live here — an early worker's
            # REGISTER (decrementing _num_starting) raced this loop's
            # `+= 1` on the main thread, and the lost update permanently
            # skewed the startup-concurrency budget (found by fieldsan).
            self._events.put(("timer", lambda: [
                self._spawn_worker() for _ in range(n_pre)]))
        telemetry.attach_node(self)
        self.events.info("NODE_START", "node service started",
                         resources=dict(self.resources_total),
                         address=self.tcp_address or self.socket_path)

    def stop(self, kill_workers: bool = True,
             graceful: bool = True) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        self.dead = True
        telemetry.detach_node(self)
        try:
            self.gcs.remove_node(self.node_id, reason="node stopped")
        except Exception:   # remote GCS may already be gone
            pass
        for listener in (self._listener, self._tcp_listener):
            if listener is not None:
                try:
                    listener.close()
                except OSError:
                    pass
        if self.shm_probe_path:
            try:
                os.unlink(self.shm_probe_path)
            except OSError:
                pass
        for peer in list(self._peers.values()):
            peer.close()
        self._peers.clear()
        if graceful:
            # graceful-death announcement: workers drain queued
            # outbound frames (a TASK_DONE sitting in the writer queue)
            # and exit; drivers fail pending futures with "node
            # shutting down" instead of a bare connection-reset.
            # Skipped on the kill() chaos path, which must look like a
            # crash (reader EOF / heartbeat timeout), not a farewell.
            for conn in list(self._conns.values()):
                try:
                    conn.send((P.SHUTDOWN, ()))
                except OSError:
                    pass
        self._events.put(("stop",))
        if kill_workers:
            if graceful:
                # give workers a beat to act on the SHUTDOWN frame
                # (drain queued TASK_DONEs, close, exit) before the
                # SIGKILL below reaps stragglers — responsive workers
                # exit in single-digit ms, so this usually costs one
                # poll; the cap bounds a wedged worker's hold
                deadline = time.monotonic() + 0.25
                procs = [w.proc for w in self._workers.values()
                         if w.proc is not None]
                while (time.monotonic() < deadline
                       and any(p.poll() is None for p in procs)):
                    time.sleep(0.01)
            for w in list(self._workers.values()):
                if w.proc is not None:
                    try:
                        w.proc.kill()
                    except OSError:
                        pass
        for w in list(self._workers.values()):
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=5)
                except Exception:
                    pass
        self.store.shutdown()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    def kill(self) -> None:
        """Simulate abrupt node failure (for chaos tests)."""
        self.stop(kill_workers=True, graceful=False)

    # ------------------------------------------------------ cross-thread API
    def available_snapshot(self) -> Dict[str, float]:
        with self._res_lock:
            return dict(self.resources_available)

    def reserve_bundle(self, pg_key: tuple, demand: Dict[str, float]) -> bool:
        with self._res_lock:
            if not sched.fits(self.resources_available, demand):
                return False
            sched.subtract(self.resources_available, demand)
            self.pg_reservations[pg_key] = dict(demand)
            self.pg_bundle_total[pg_key] = dict(demand)
            return True

    def release_bundle(self, pg_key: tuple) -> None:
        with self._res_lock:
            total = self.pg_bundle_total.pop(pg_key, None)
            self.pg_reservations.pop(pg_key, None)
            if total:
                sched.add(self.resources_available, total)

    def post_remote(self, item: tuple) -> None:
        """Called by peer node services / cluster utilities."""
        self._events.put(item)

    # ------------------------------------------------------------- threads
    def _accept_loop(self, listener) -> None:
        while not self._stopped.is_set():
            try:
                sock, _ = listener.accept()
            except OSError:
                return
            conn = P.Connection(sock)
            key = next(self._conn_keys)
            self._conns[key] = conn
            t = threading.Thread(target=self._reader_loop, args=(key, conn),
                                 daemon=True)
            t.start()

    # --------------------------------------------------------- log streaming
    def _log_tail_loop(self) -> None:
        """Tail THIS node's workers' logs and publish new lines
        cluster-wide (reference: ``python/ray/_private/log_monitor.py:103``).
        Every node forwards LOG events to its locally-connected drivers,
        so a ``print()`` in any remote task shows up on the driver's
        stdout. Only our own workers are tailed — in-process clusters
        share one session dir, and K nodes each tailing it would print
        every line K times (and replay history on scale-up)."""
        offsets: Dict[str, int] = {}
        labels: Dict[str, str] = {}
        quiet_since: Dict[str, float] = {}
        while not self._stopped.wait(0.25):
            workers = list(self._workers.values())
            live_paths = {w.log_path for w in workers if w.log_path}
            for w in workers:
                if w.log_path and w.log_label:
                    labels[w.log_path] = w.log_label
            # keep tailing files we've seen: a worker's last lines often
            # land right as it is reaped from self._workers — but prune
            # a DEAD worker's path once its file has been quiet for a
            # while (worker churn must not grow these dicts, or re-stat
            # every dead replica's log forever)
            paths = live_paths | set(offsets)
            now_t = time.monotonic()
            for path in paths:
                try:
                    size = os.path.getsize(path)
                    off = offsets.get(path, 0)
                    if size <= off:
                        if path not in live_paths:
                            first = quiet_since.setdefault(path, now_t)
                            if now_t - first > 30.0:
                                offsets.pop(path, None)
                                labels.pop(path, None)
                                quiet_since.pop(path, None)
                        continue
                    quiet_since.pop(path, None)
                    with open(path, "rb") as f:
                        f.seek(off)
                        data = f.read(min(size - off, 1 << 20))
                except OSError:
                    # file gone: nothing left to drain for it
                    if path not in live_paths:
                        offsets.pop(path, None)
                        labels.pop(path, None)
                        quiet_since.pop(path, None)
                    continue
                # consume only whole lines; a read landing mid-write
                # leaves the partial tail for the next poll
                consumed = data.rfind(b"\n") + 1
                if consumed == 0:
                    continue
                offsets[path] = off + consumed
                lines = data[:consumed].decode("utf-8", "replace"
                                               ).splitlines()
                worker = os.path.basename(path)[len("worker-"):-len(".log")]
                for i in range(0, len(lines), 200):
                    try:
                        self.gcs.publish("LOG", {
                            "node_id": self.node_id.hex()[:12],
                            "worker": worker,
                            "label": labels.get(path),
                            "lines": lines[i:i + 200],
                        })
                    except Exception:
                        break

    def _on_log_event(self, payload) -> None:
        """Forward worker log lines to locally-connected drivers."""
        for key in list(self._driver_conn_keys):
            self._reply(key, P.EVENT, ("LOG", payload))

    def _tick_loop(self) -> None:
        while True:
            # the memory monitor may need sub-second sampling to catch a
            # ballooning worker before the kernel OOM-killer does; the
            # other tick work tolerates running at the same faster cadence
            mm_period = CONFIG.memory_monitor_refresh_ms
            interval = min(1.0, mm_period / 1000.0) if mm_period > 0 else 1.0
            if self._stopped.wait(interval):
                return
            # Heartbeat from THIS thread, not the dispatcher: a slow peer
            # RPC can block the dispatcher past the GCS death deadline
            # (health period × threshold), and a healthy node must not be
            # declared dead because one transfer is slow.
            now_hb = time.monotonic()
            if now_hb - self._last_hb_at >= \
                    CONFIG.heartbeat_period_ms / 1000.0:
                self._last_hb_at = now_hb
                snap = self.available_snapshot()
                pend = self.pending_demand()
                # versioned delta sync (reference: ray_syncer.h:86):
                # ship the payload when the view changed, bumping the
                # monotonic version; every Nth beat is a full refresh
                # so a GCS that lost state (restart) converges even on
                # an otherwise-idle node
                self._hb_count += 1
                changed = (snap != self._last_hb_snapshot
                           or pend != self._last_hb_pending
                           or self._hb_count % 10 == 0)
                if changed:
                    self._resource_version += 1
                try:
                    self.gcs.heartbeat(
                        self.node_id,
                        snap if changed else None,
                        pending_shapes=pend if changed else None,
                        version=self._resource_version)
                except Exception:
                    # the payload did NOT land: leave the last-sent view
                    # unchanged so the next beat re-detects the delta
                    # and resends (committing early would drop it)
                    pass
                else:
                    if changed:
                        self._last_hb_snapshot = snap
                        self._last_hb_pending = pend
            self._events.put(("timer", self._on_tick))

    def _on_tick(self) -> None:
        self._reap_startup_failures()
        self._reap_idle_workers()
        self._check_memory_pressure()
        self._retry_infeasible()
        self._spill_starved_pending()
        self._rescue_stalled_waiters()
        self._sweep_stalls()
        self._sweep_object_leaks()
        self._drain_spill_events()
        self._record_metrics_history()
        # _dispatch fails pending tasks whose env exceeded the startup
        # failure budget (see the wid-None path)
        self._dispatch()

    # concurrency: dispatcher-only
    def _rescue_stalled_waiters(self) -> None:
        """Self-heal the readiness plane: a get/wait waiter whose object
        EXISTS can still be stranded — the register-time existence probe
        can transiently miss (a remote owner's store peek failing or
        timing out under load) AFTER the one OBJECT readiness event was
        already consumed, leaving nothing to ever fire the waiter. The
        tick re-probes waiters older than a beat with METADATA-ONLY
        evidence (local store / control-plane directory — no peer store
        RPC, so a tick stays cheap) and fires the ones that resolved;
        ``_fire_get``'s lookup still pulls or fails loudly."""
        if not self._get_waiters and not self._wait_waiters:
            return
        now = time.monotonic()
        # plane probes per tick (a remote node's directory lookup is an
        # RPC). A waiter too big for the REMAINING budget is skipped —
        # never `return` — so one huge get can't monopolize every tick
        # and starve a small stranded waiter behind it; oversized
        # waiters (> the whole budget) rely on the normal event flow
        # (the race this rescue closes strands few-oid waiters).
        budget = 256
        for waiter_id, waiter in (list(self._get_waiters.items())
                                  + list(self._wait_waiters.items())):
            if (now < waiter.probe_at or not waiter.remaining
                    or len(waiter.remaining) > budget):
                continue
            budget -= len(waiter.remaining)
            resolved = [oid for oid in waiter.remaining
                        if self._oid_rescuable(oid)]
            if not resolved:
                # nothing there yet (producer still running): back off
                # exponentially so steady-state cost per waiter decays
                waiter.probe_backoff = min(waiter.probe_backoff * 2, 30.0)
                waiter.probe_at = now + waiter.probe_backoff
                continue
            for oid in resolved:
                waiter.remaining.discard(oid)
                ids = self._obj_waiter_index.get(oid)
                if ids is not None:
                    ids.discard(waiter_id)
                    if not ids:
                        del self._obj_waiter_index[oid]
            self._maybe_fire_waiter(waiter_id, waiter)

    def _oid_rescuable(self, oid: ObjectID) -> bool:
        """Cheap existence evidence for the waiter rescue: our store,
        or a directory row (the object was sealed SOMEWHERE — for a
        task we own, only once the task finished, so a waiter on an
        in-flight retry is never fired early)."""
        if self.store.contains(oid):
            return True
        tid = TaskID(TaskID.KIND + oid.binary()[:15])
        owned = self._owned.get(tid)
        if owned is not None and not owned.done:
            return False        # still running: completion fires it
        try:
            return self.gcs.lookup_location(oid) is not None
        except Exception:       # noqa: BLE001 — plane hiccup: next tick
            return False

    def _sweep_stalls(self) -> None:
        """Trigger the control plane's stall detector. Only nodes
        hosting the plane in-process run it (in a networked cluster
        that's the head; remote nodes triggering over RPC would just
        race the head's sweep). The plane self-rate-limits, so the
        in-process multi-node case — every node sharing one plane —
        still sweeps once per interval."""
        if not isinstance(self.gcs, GlobalControlPlane):
            return
        try:
            stalls = self.gcs.maybe_sweep_stalls(
                coll_probe=self._coll_stall_probe)
        except Exception:   # noqa: BLE001 — diagnosis must not kill ticks
            return
        for rec in stalls:
            self.events.warning("TASK_STALL",
                                rec.pop("message", "task stalled"), **rec)

    def _sweep_object_leaks(self) -> None:
        """Trigger the control plane's object-leak sweep (same
        plane-hosting-node rule as ``_sweep_stalls``; the plane
        self-rate-limits). New findings become OBJECT_LEAK WARNING
        events carrying the creation callsite; the current finding
        count feeds the ``rtpu_object_leaked_objects`` gauge."""
        if not isinstance(self.gcs, GlobalControlPlane):
            return
        try:
            new, total = self.gcs.sweep_object_leaks()
        except Exception:   # noqa: BLE001 — diagnosis must not kill ticks
            return
        if total is not None:
            telemetry.gauge_set(telemetry.M_OBJ_LEAKED, float(total),
                                self._mtags)
        for rec in new:
            oid = rec.pop("object_id")
            # the object's LOCATION rides under its own key: **rec would
            # otherwise clobber EventLogger's standard node_id field
            # (the emitting node's hex) with a raw NodeID/None
            loc = rec.pop("node_id", None)
            where = (f" created at {rec['callsite']}" if rec.get("callsite")
                     else "")
            why = ("every ref holder lives on a dead node"
                   if rec.get("cause") == "dead_holders" else
                   f"pinned with zero holders for {rec.get('age_s', '?')}s")
            self.events.warning(
                "OBJECT_LEAK",
                f"object {oid.hex()[:12]}{where} looks leaked: {why}",
                object_id=oid.hex(),
                object_node_id=(loc.hex() if loc is not None else None),
                **rec)

    def _drain_spill_events(self) -> None:
        """Publish the store's spill/restore activity recorded since the
        last tick: byte counters for the doctor/bench planes plus
        attributed OBJECT_SPILLED / OBJECT_RESTORED cluster events — the
        spill carries the object's creation callsite from the
        provenance table when the plane is in-process. Runs outside the
        store lock by design (the store only queues; emitting under its
        lock would nest store.entries → gcs/telemetry locks)."""
        try:
            evts = self.store.drain_spill_events()
        except Exception:   # noqa: BLE001 — ticks must survive the store
            return
        if not evts:
            return
        spilled_bytes = sum(sz for kind, _, sz in evts if kind == "spill")
        restored = sum(1 for kind, _, _ in evts if kind == "restore")
        if spilled_bytes:
            telemetry.counter_inc(telemetry.M_OBJ_SPILLED_BYTES,
                                  float(spilled_bytes), self._mtags)
        if restored:
            telemetry.counter_inc(telemetry.M_OBJ_RESTORED,
                                  float(restored), self._mtags)
        prov: dict = {}
        if isinstance(self.gcs, GlobalControlPlane):
            try:
                prov = self.gcs.objects_info(
                    [oid for kind, oid, _ in evts if kind == "spill"])
            except Exception:   # noqa: BLE001 — events still emit bare
                prov = {}
        for kind, oid, size in evts:
            if kind == "spill":
                rec = prov.get(oid) or {}
                callsite = rec.get("callsite")
                where = f" created at {callsite}" if callsite else ""
                self.events.info(
                    "OBJECT_SPILLED",
                    f"object {oid.hex()[:12]} ({size} B){where} spilled "
                    f"to disk under memory pressure",
                    object_id=oid.hex(), size=size, callsite=callsite,
                    creator=(str(rec["creator"])
                             if rec.get("creator") else None))
            else:
                self.events.info(
                    "OBJECT_RESTORED",
                    f"object {oid.hex()[:12]} ({size} B) restored from "
                    f"its spill file on demand",
                    object_id=oid.hex(), size=size)

    def _record_metrics_history(self) -> None:
        """Tick-driven history snapshot: the plane-hosting node (same
        rule as the stall/leak sweeps — the plane self-rate-limits to
        its finest level step) flushes its own telemetry shards and
        appends one retention frame, then publishes the ring's byte
        footprint."""
        if not isinstance(self.gcs, GlobalControlPlane):
            return
        try:
            telemetry.maybe_flush(0.5)
            total = self.gcs.record_history_snapshot()
        except Exception:   # noqa: BLE001 — retention must not kill ticks
            return
        if total is not None:
            telemetry.gauge_set(history_mod.M_HISTORY_BYTES, float(total))

    def _coll_stall_probe(self, candidates: List[tuple]) -> List[tuple]:
        """``collective_stuck`` half of the stall sweep (runs on the
        tick thread, OUTSIDE the plane lock). Cheap pre-filter first:
        one COLL_PROGRESS fan-out — no stuck collective anywhere means
        no stack collection at all. Only when the diagnoser has a
        verdict do we collect cluster stacks and pair each candidate
        task (by the task_id its worker's dump now carries) with a
        thread parked in ``coll_transport.wait``."""
        verdicts = []
        try:
            report = self.collective_health(
                min(2.0, CONFIG.coll_progress_timeout_s), quiet=True)
            verdicts = report.get("verdicts") or []
        except Exception:   # noqa: BLE001 — diagnosis is best-effort
            return []
        if not verdicts:
            return []
        try:
            stacks = self._collect_nodes_debug(("stacks", 1.0), 1.0)
        except Exception:   # noqa: BLE001
            return []
        by_task = {}
        for dumps in stacks.values():
            for d in dumps or []:
                if d.get("task_id"):
                    by_task[d["task_id"]] = d
        # worker -> collective groups it belongs to, so a candidate gets
        # the verdict for ITS stuck group (two concurrently-stuck groups
        # must not cross-attribute their diagnoses)
        groups_of = {}
        for m in report.get("members", ()):
            if m.get("worker_id"):
                groups_of.setdefault(m["worker_id"], set()).add(
                    m["group"])
        out = []
        for ev, age in candidates:
            dump = by_task.get(ev.task_id.hex())
            if dump is None:
                continue
            in_coll = any(
                "coll_transport" in fr and "wait" in fr
                for th in dump.get("threads", ())
                for fr in th.get("frames", ()))
            if not in_coll:
                continue
            my_groups = groups_of.get(dump.get("worker_id"), set())
            matched = [v for v in verdicts if v.get("group") in my_groups]
            if not matched:
                # no verdict for THIS task's groups: it is not stuck in
                # a diagnosed collective — never cross-attribute another
                # group's diagnosis
                continue
            verdict_msg = matched[0].get(
                "message", "see state.collective_health()")
            out.append((ev, "collective_stuck",
                        f"task {ev.name!r} has been parked in a "
                        f"collective wait for {age:.0f}s (past "
                        f"collective_timeout_s/2) — {verdict_msg}"))
        return out

    def _check_memory_pressure(self) -> None:
        """Kill one worker per check while above the usage threshold
        (reference: memory_monitor.h:52 + worker_killing_policy.h:34)."""
        period = CONFIG.memory_monitor_refresh_ms
        if period <= 0:
            return
        now = time.monotonic()
        if now - self._last_mem_check < period / 1000.0:
            return
        self._last_mem_check = now
        frac = self._memory_monitor.usage_fraction()
        if frac < CONFIG.memory_usage_threshold:
            return
        victim = memory_monitor.pick_oom_victim(
            self._workers.values(),
            # restarts_left == -1 means restart forever (same contract as
            # the restart path below): that actor is maximally retriable
            actor_restartable=lambda aid: (
                (self._actors.get(aid) or {}).get("restarts_left", 0) != 0),
            # among equally-retriable candidates kill the biggest RSS:
            # that is the kill that actually relieves the pressure
            rss_of=lambda w: memory_monitor.process_rss_bytes(
                w.proc.pid if w.proc is not None else (w.pid or -1)))
        if victim is None:
            return
        pid = victim.proc.pid if victim.proc is not None else victim.pid
        if pid is None:
            # externally-registered worker we cannot signal: killing only
            # its connection would leave the process running (no memory
            # freed, task double-executes on retry)
            return
        victim.oom_victim = True
        snap = self._memory_monitor.snapshot()
        rss = memory_monitor.process_rss_bytes(pid)
        top = self._oom_autopsy(victim)
        print(f"[rtpu] node {self.node_id.hex()[:8]}: memory usage "
              f"{frac:.0%} >= threshold "
              f"{CONFIG.memory_usage_threshold:.0%}; killing worker "
              f"pid={pid} ({snap['available_bytes']>>20} MiB avail)",
              file=sys.stderr)
        # autopsy in the event itself: the victim's RSS plus the top
        # objects it owned/held, each with its creation callsite — the
        # kill names its probable cause instead of a bare OOM_KILL
        message = ("memory monitor killed a worker to relieve node "
                   f"memory pressure (victim rss {rss >> 20} MiB)")
        if top:
            t0 = top[0]
            where = (f", created at {t0['callsite']}" if t0.get("callsite")
                     else "")
            message += (f"; top held object {t0['object_id'][:12]} "
                        f"({t0.get('size') or '?'} B{where})")
        self.events.warning(
            "OOM_KILL", message, pid=pid,
            usage_fraction=round(frac, 3),
            rss_bytes=rss,
            top_objects=top,
            task=(victim.task.spec.name if victim.task else None),
            actor_id=(victim.actor_id.hex() if victim.actor_id else None))
        # a kill under memory pressure is a terminal event worth a
        # corpse: capture a post-mortem bundle off-thread (the tick
        # must not stall on the stack/flight-record fan-outs)
        from . import debug_bundle
        debug_bundle.auto_capture("oom_kill", node=self,
                                  fields={"victim_pid": pid},
                                  background=True)
        try:
            if victim.proc is not None:
                victim.proc.kill()
            else:
                os.kill(pid, signal.SIGKILL)
        except OSError:
            pass

    def _oom_autopsy(self, victim) -> List[dict]:
        """Top objects the OOM victim owned/held: refs registered on its
        connection plus the resolved args of its running/pipelined
        tasks, sized and attributed through the control plane in one
        ``objects_info`` batch. Best-effort and bounded — the kill must
        not wait on a slow plane."""
        oids: List[ObjectID] = []
        seen = set()
        if victim.conn_key is not None:
            for oid in list(self._conn_refs.get(victim.conn_key) or ()):
                if oid not in seen:
                    seen.add(oid)
                    oids.append(oid)
        for rec in (([victim.task] if victim.task is not None else [])
                    + list(victim.pipeline)):
            for oid in rec.deps:
                if oid not in seen:
                    seen.add(oid)
                    oids.append(oid)
        if not oids:
            return []
        try:
            info = self.gcs.objects_info(oids[:64])
        except Exception:   # noqa: BLE001 — autopsy is best-effort
            return []
        rows = sorted(info.values(),
                      key=lambda r: -(r.get("size") or 0))[:5]
        return [{"object_id": r["object_id"].hex(),
                 "size": r.get("size"),
                 "callsite": r.get("callsite"),
                 "creator": r.get("creator")} for r in rows]

    def _park_infeasible(self, kind: str, spec) -> bool:
        """Queue work with no feasible node while the autoscaler adds
        capacity; False when fail-fast semantics apply (grace 0)."""
        grace = CONFIG.infeasible_task_grace_s
        if grace <= 0:
            return False
        deadline = (self._repark_deadline if self._repark_deadline
                    is not None else time.monotonic() + grace)
        self._infeasible.append((deadline, kind, spec))
        return True

    def _fail_actor_infeasible(self, spec: P.ActorSpec) -> None:
        self.gcs.set_actor_state(spec.actor_id, ACTOR_DEAD,
                                 reason="no feasible node")
        if spec.creation_return_id:
            err = to_bytes(exceptions.ActorDiedError(
                spec.actor_id, "no feasible node for actor resources"))
            self._seal_object(ObjectMeta(
                object_id=spec.creation_return_id, size=len(err),
                error=err))

    def _retry_infeasible(self) -> None:
        if not self._infeasible:
            return
        parked, self._infeasible = self._infeasible, []
        now = time.monotonic()
        for deadline, kind, spec in parked:
            if self._probe_target(spec) is not None:
                # keep the original deadline if routing re-parks (the
                # cluster changed between probe and route)
                self._repark_deadline = deadline
                try:
                    if kind == "task":
                        self._route_task(spec)
                    else:
                        self._route_actor(spec)
                finally:
                    self._repark_deadline = None
            elif now < deadline:
                self._infeasible.append((deadline, kind, spec))
            elif kind == "task":
                self._record_event(spec, "FAILED")
                self._fail_returns(spec, RuntimeError(
                    f"no feasible node for resources {spec.resources} "
                    f"within {CONFIG.infeasible_task_grace_s}s"))
            else:
                self._fail_actor_infeasible(spec)

    def pending_demand(self) -> List[Dict[str, float]]:
        """Queued-but-unplaced resource shapes (autoscaler input)."""
        shapes: List[Dict[str, float]] = []
        try:
            for rec in list(self._pending)[:100]:
                shapes.append(dict(rec.spec.resources))
            for _, kind, spec in list(self._infeasible)[:100]:
                shapes.append(dict(spec.resources))
        except RuntimeError:   # racy snapshot from the tick thread
            pass
        return shapes

    # Ops answered inline on the connection-reader thread. The object
    # plane and bundle reservation are thread-safe (store RLock /
    # _res_lock) and MUST NOT wait on the dispatcher: peer A's
    # dispatcher may be blocked on a request to B while B's is blocked
    # on a request to A. Puts (alloc/seal) are also served here so a
    # 100MB memcpy-heavy put stream never queues behind task dispatch —
    # the same separation the reference gets from plasma being its own
    # process.
    _DIRECT_OPS = frozenset({P.NODE_POST, P.OBJ_GET_META, P.OBJ_UNPIN,
                             P.OBJ_PULL_CHUNK, P.PG_RESERVE,
                             P.PG_RELEASE, P.NODE_STATS, P.ALLOC_OBJECT,
                             P.PUT_OBJECT, P.PUT_OBJECT_SYNC,
                             P.PUT_OBJECT_WIRE,
                             # debug plane: replies resolve futures and
                             # collection requests spawn their own
                             # thread, so neither may queue behind (or
                             # block) the dispatcher
                             P.STACK_REPLY, P.PROFILE_REPORT,
                             P.CLUSTER_STACKS, P.CLUSTER_PROFILE,
                             P.COLL_PROGRESS_REPLY, P.CLUSTER_COLL,
                             # collective chunks are data plane: routed
                             # on the arrival reader thread so a ring
                             # step never queues behind task dispatch
                             P.COLL_ROUTE, P.COLL_FWD})

    def _reader_loop(self, key: int, conn: P.Connection) -> None:
        while True:
            # burst receive: every frame the peer's writer coalesced is
            # decoded in one wakeup; non-direct messages post to the
            # dispatcher as ONE event so a 100-frame burst is one
            # scheduling pass, not 100 queue round-trips
            msgs = conn.recv_many()
            if msgs is None:
                self._events.put(("conn_closed", key))
                return
            queued: Optional[List[tuple]] = None
            for msg in msgs:
                if msg[0] in self._DIRECT_OPS:
                    try:
                        self._handle_direct(key, *msg)
                    except Exception:
                        import traceback
                        traceback.print_exc(file=sys.stderr)
                        # request-type ops carry (req_id, ...): answer so
                        # the caller doesn't block out its full timeout
                        op, payload = msg
                        if op in (P.OBJ_GET_META, P.OBJ_PULL_CHUNK,
                                  P.PG_RESERVE, P.NODE_STATS,
                                  P.ALLOC_OBJECT, P.CLUSTER_STACKS,
                                  P.CLUSTER_PROFILE, P.CLUSTER_COLL
                                  ) and isinstance(payload, tuple):
                            result = False if op == P.PG_RESERVE else None
                            self._reply(key, P.INFO_REPLY,
                                        (payload[0], result))
                        elif (op in (P.PUT_OBJECT_SYNC, P.PUT_OBJECT_WIRE)
                              and isinstance(payload, tuple)):
                            err = to_bytes(RuntimeError(
                                "put failed on the node store"))
                            self._reply(key, P.ERROR_REPLY,
                                        (payload[0], err))
                else:
                    if queued is None:
                        queued = []
                    queued.append(msg)
            if queued:
                self._events.put(("msgs", key, queued))

    def _handle_direct(self, key: int, op: int, payload: Any) -> None:
        if op == P.NODE_POST:
            self._events.put(tuple(payload))
        elif op in (P.COLL_ROUTE, P.COLL_FWD):
            dst_node, dst_wid, coll_key, data = payload
            self._coll_route(dst_node, dst_wid, coll_key, data)
        elif op == P.OBJ_GET_META:
            req_id, oid, pin = payload
            meta = (self.store.pin_and_get(oid) if pin
                    else self.store.get_meta(oid))
            self._reply(key, P.INFO_REPLY, (req_id, meta))
        elif op == P.OBJ_UNPIN:
            self.store.unpin(payload)
        elif op == P.OBJ_PULL_CHUNK:
            req_id, oid, offset, length = payload
            res = self.store.read_payload_chunk(oid, offset, length)
            if res is not None and res[1] is not None:
                # chunk bytes ride out-of-band: straight from the store
                # copy to the socket as an iovec, no pickle-stream copy
                res = (res[0], P.oob_wrap(res[1]))
            self._reply(key, P.INFO_REPLY, (req_id, res))
        elif op == P.PG_RESERVE:
            req_id, pg_key, demand = payload
            self._reply(key, P.INFO_REPLY,
                        (req_id, self.reserve_bundle(tuple(pg_key), demand)))
        elif op == P.PG_RELEASE:
            self.release_bundle(tuple(payload))
        elif op == P.NODE_STATS:
            req_id, what = payload
            if isinstance(what, tuple):
                # debug collections ("stacks"/"profile") block for up to
                # their timeout waiting on worker replies; a dedicated
                # thread keeps this peer channel's reader serving object
                # pulls meanwhile
                self._spawn_debug_reply(key, req_id,
                                        lambda w=what: self.node_stats(w))
            else:
                self._reply(key, P.INFO_REPLY,
                            (req_id, self.node_stats(what)))  # lint: allow-on-reader(non-tuple whats are pure snapshots; the blocking tuple forms take the _spawn_debug_reply thread above)
        elif op in (P.STACK_REPLY, P.PROFILE_REPORT,
                    P.COLL_PROGRESS_REPLY):
            token, data = payload
            with self._debug_lock:
                fut = self._debug_futures.pop(token, None)
            if fut is not None and not fut.done():
                fut.set_result(data)
        elif op == P.CLUSTER_COLL:
            req_id, what, timeout_s = payload
            self._spawn_debug_reply(
                key, req_id,
                lambda w=what, t=timeout_s: (
                    self.collective_health(float(t)) if w == "health"
                    else self.collect_flight_records(float(t))))
        elif op == P.CLUSTER_STACKS:
            req_id, timeout_s = payload
            self._spawn_debug_reply(
                key, req_id,
                lambda t=timeout_s: self.cluster_stacks(float(t)))
        elif op == P.CLUSTER_PROFILE:
            req_id, opts = payload
            self._spawn_debug_reply(
                key, req_id,
                lambda o=opts: self.cluster_profile(dict(o or {})))
        elif op == P.ALLOC_OBJECT:
            req_id, oid, size = payload
            try:
                ref = self.store.alloc_in_arena(oid, size, writer_tag=key)
            except Exception:   # noqa: BLE001 — client blocks on a reply
                ref = None
            self._reply(key, P.INFO_REPLY, (req_id, ref))
        elif op == P.PUT_OBJECT:
            self._seal_object(payload)
        elif op == P.PUT_OBJECT_SYNC:
            req_id, meta = payload
            try:
                self._seal_object(meta)
            except Exception as e:  # noqa: BLE001 — client put() blocks
                self._reply(key, P.ERROR_REPLY, (req_id, to_bytes(e)))
            else:
                self._reply(key, P.PUT_REPLY, (req_id,))
        elif op == P.PUT_OBJECT_WIRE:
            # cross-host driver put: the payload arrived over the socket
            # (a zero-copy out-of-band view into the frame buffer for
            # large transfers); land it straight in an arena block /
            # segment as the primary copy — one copy off the socket
            req_id, oid, data = payload
            try:
                meta = self.store.put_payload(oid, data)
                # adopt already ran inside put_payload; _seal_object's
                # re-adopt is a no-op and it publishes the location
                self._seal_object(meta)
            except Exception as e:  # noqa: BLE001 — client put() blocks
                self._reply(key, P.ERROR_REPLY, (req_id, to_bytes(e)))
            else:
                self._reply(key, P.PUT_REPLY, (req_id,))

    def _coll_route(self, dst_node: bytes, dst_wid: bytes, coll_key,
                    data) -> None:
        """Deliver one collective chunk: to a local process's conn when
        the destination endpoint lives here, else across the node plane.
        Runs on reader threads (data plane — never the dispatcher).
        Fire and forget: an unroutable chunk (dead process/node) is
        dropped and surfaces as the receiving rank's deadline."""
        if dst_node == self.node_id.binary():
            conn = self._coll_conns.get(dst_wid)
            if conn is None:
                return
            try:
                conn.send((P.COLL_DELIVER, (coll_key, data)))
            except OSError:
                pass
            return
        peer = self._coll_peers.get(dst_node)
        if peer is not None and (peer.closed if isinstance(peer, _RemotePeer)
                                 else peer.dead):
            peer = None
        if peer is None:
            peer = self._peer(NodeID(dst_node))  # lint: allow-on-reader(one gcs.get_node RPC per peer-lifetime cache miss; steady-state chunks hit _coll_peers — the documented tradeoff)
            if peer is None:
                return
            self._coll_peers[dst_node] = peer
        if isinstance(peer, NodeService):
            peer._coll_route(dst_node, dst_wid, coll_key, data)
        else:
            peer.coll_forward((dst_node, dst_wid, coll_key, data))

    def node_stats(self, what) -> Any:
        """Cross-thread node introspection (also served to peers).
        Tuple forms carry arguments: ``("stacks", timeout_s)`` and
        ``("profile", opts)`` are this node's debug-collection surface
        for remote peers."""
        if isinstance(what, tuple) and what:
            if what[0] == "stacks":
                return self.collect_local_stacks(float(what[1]))
            if what[0] == "profile":
                return self.collect_local_profile(dict(what[1] or {}))
            if what[0] == "coll":
                return self.collect_local_coll_progress(float(what[1]))
            return None
        if what == "available":
            return self.available_snapshot()
        if what == "store":
            return self.store.stats()
        if what == "workers":
            for _ in range(3):   # dict may be mutated by the dispatcher
                try:
                    return [{
                        "worker_id": wid.hex(),
                        "node_id": self.node_id.hex(),
                        "pid": w.proc.pid if w.proc else None,
                        "state": w.state,
                        "actor_id": (w.actor_id.hex()
                                     if w.actor_id else None),
                    } for wid, w in list(self._workers.items())]
                except RuntimeError:
                    continue
            return []
        if what == "memory":
            return self._memory_monitor.snapshot()
        if what == "objects":
            # per-object (pinned, spilled) from THIS node's store — the
            # node-local half of the memory introspection plane
            return self.store.objects_snapshot()
        return None

    # -------------------------------------------- debugging & profiling
    # Reference analogues: `ray stack` (py-spy over every worker pid)
    # and the profiling hooks. Here: STACK_DUMP/PROFILE_START frames fan
    # out to every locally-connected worker/driver; replies resolve
    # futures on each connection's reader thread, so a process blocked
    # in user code (even in get()) still reports.

    def _spawn_debug_reply(self, key: int, req_id: int, fn) -> None:
        """Serve a blocking debug collection off the reader thread."""
        def run():
            try:
                result = fn()
            except Exception:   # noqa: BLE001 — debugging is best-effort
                result = None
            self._reply(key, P.INFO_REPLY, (req_id, result))
        threading.Thread(target=run, daemon=True,
                         name="rtpu-debug-collect").start()

    def _debug_fanout(self, targets: List[tuple], op: int,
                      make_payload) -> List[tuple]:
        """Send one debug frame per target conn; returns [(future,
        extra), ...] for the sends that left."""
        waits = []
        for conn, extra in targets:
            with self._debug_lock:
                token = self._next_debug_token
                self._next_debug_token += 1
                fut: Future = Future()
                self._debug_futures[token] = fut
            try:
                conn.send((op, make_payload(token)))
            except OSError:
                with self._debug_lock:
                    self._debug_futures.pop(token, None)
                continue
            waits.append((token, fut, extra))
        return waits

    def _debug_collect(self, waits: List[tuple],
                       timeout_s: float) -> List[Any]:
        out = []
        deadline = time.monotonic() + timeout_s
        for token, fut, extra in waits:
            try:
                data = fut.result(
                    timeout=max(0.05, deadline - time.monotonic()))
            except Exception:   # timeout / conn died mid-collection
                with self._debug_lock:
                    self._debug_futures.pop(token, None)
                continue
            if isinstance(data, dict):
                for k, v in extra.items():
                    data.setdefault(k, v)
                out.append(data)
        return out

    def collect_local_stacks(self, timeout_s: float = 2.0) -> List[dict]:
        """Thread dumps of this node process + every locally-connected
        worker and driver."""
        from . import debugging
        node_hex = self.node_id.hex()[:12]
        dumps = [debugging.collect_stack_dump(kind="node",
                                              node_id=node_hex)]
        targets = []
        for w in list(self._workers.values()):
            if w.conn is not None:
                targets.append((w.conn, {"node_id": node_hex}))
        for key in list(self._driver_conn_keys):
            conn = self._conns.get(key)
            if conn is not None:
                targets.append((conn, {"node_id": node_hex}))
        waits = self._debug_fanout(targets, P.STACK_DUMP, lambda t: t)
        dumps.extend(self._debug_collect(waits, timeout_s))
        return dumps

    def collect_local_profile(self, opts: dict) -> List[dict]:
        """Start the sampling profiler in every local worker; block
        until their reports arrive (bounded by the capped duration)."""
        duration = min(float(opts.get("duration_s") or 5.0),
                       CONFIG.profiler_max_duration_s)
        opts = {**opts, "duration_s": duration}
        opts.setdefault("interval_ms", CONFIG.profiler_default_interval_ms)
        node_hex = self.node_id.hex()[:12]
        targets = [(w.conn, {"node_id": node_hex,
                             "worker_id": w.worker_id.hex()})
                   for w in list(self._workers.values())
                   if w.conn is not None]
        waits = self._debug_fanout(targets, P.PROFILE_START,
                                   lambda t: (t, opts))
        return self._debug_collect(waits, duration + 10.0)

    def collect_local_coll_progress(self, timeout_s: float = 2.0
                                    ) -> List[dict]:
        """Flight-recorder progress snapshots of every locally-connected
        worker AND driver (a driver can be a collective rank). Replies
        arrive on each process's reader thread — a rank wedged inside
        the collective being diagnosed still answers."""
        node_hex = self.node_id.hex()[:12]
        targets = []
        for w in list(self._workers.values()):
            if w.conn is not None:
                targets.append((w.conn, {"node_id": node_hex}))
        for key in list(self._driver_conn_keys):
            conn = self._conns.get(key)
            if conn is not None:
                targets.append((conn, {"node_id": node_hex}))
        waits = self._debug_fanout(targets, P.COLL_PROGRESS, lambda t: t)
        return self._debug_collect(waits, timeout_s)

    def _collect_cluster_coll(self, timeout_s: float) -> Dict[str, Any]:
        return {hexid: snaps or []
                for hexid, snaps in self._collect_nodes_debug(
                    ("coll", timeout_s), timeout_s).items()}

    def collective_health(self, timeout_s: Optional[float] = None,
                          quiet: bool = False) -> dict:
        """Cluster-wide collective hang & straggler diagnosis: collect
        every rank's flight-recorder watermarks, diff them, and name
        the verdict per stuck op — dead rank, lost chunk, or lagging
        rank (with the lagging rank's current thread stack attached
        from a stack dump when one can be matched)."""
        from . import flight_recorder
        cached_at, cached = self._coll_health_cache
        if cached is not None and time.monotonic() - cached_at < 1.0:
            return cached
        t = timeout_s if timeout_s is not None \
            else CONFIG.coll_progress_timeout_s
        per_node = self._collect_cluster_coll(t)
        report = flight_recorder.diagnose(per_node)
        lagging = [v for v in report.get("verdicts", ())
                   if v.get("verdict") == "lagging_rank"]
        if lagging:
            self._attach_lagging_stacks(report, lagging, per_node)
        if not quiet:
            self.events.info(
                "DEBUG_COLLECTIVES",
                "collected cluster-wide collective health",
                ops=len(report.get("ops", ())),
                verdicts=len(report.get("verdicts", ())))
        self._coll_health_cache = (time.monotonic(), report)
        return report

    def _attach_lagging_stacks(self, report: dict, lagging: List[dict],
                               per_node: Dict[str, Any]) -> None:
        """Best-effort: name WHERE each lagging rank is stuck by pairing
        its endpoint with a cluster stack dump."""
        # rank -> worker hex prefix, from any snapshot's group registry
        eps: Dict[tuple, list] = {}
        for snaps in per_node.values():
            for s in snaps or []:
                for g in s.get("groups", ()):
                    if g.get("endpoints"):
                        eps[(g["group"], g["epoch"])] = g["endpoints"]
        try:
            stacks = self._collect_nodes_debug(("stacks", 1.0), 1.0)
        except Exception:   # noqa: BLE001 — stacks are garnish
            return
        dumps = [d for ds in stacks.values() for d in ds or []]
        for v in lagging:
            group_eps = eps.get((v["group"], v["epoch"])) or []
            ep = (group_eps[v["rank"]]
                  if 0 <= v["rank"] < len(group_eps) else None)
            if not ep:
                continue
            for d in dumps:
                wid = d.get("worker_id") or ""
                if not wid.startswith(ep[1]):
                    continue
                th = next(
                    (t for t in d.get("threads", ())
                     if any("coll_transport" in fr
                            for fr in t.get("frames", ()))),
                    None) or next(
                    (t for t in d.get("threads", ())
                     if t.get("thread_name") == "task-exec"), None)
                if th is not None:
                    v["stack"] = list(th.get("frames", ()))
                break

    def collect_flight_records(self, timeout_s: Optional[float] = None
                               ) -> dict:
        """Every process's raw flight-recorder snapshot (recent event
        ring + completed-op records), keyed by node."""
        t = timeout_s if timeout_s is not None \
            else CONFIG.coll_progress_timeout_s
        return {"nodes": self._collect_cluster_coll(t)}

    def _collect_nodes_debug(self, what: tuple,
                             timeout_s: float) -> Dict[str, Any]:
        """Fan a debug collection out to every alive node (in-process
        shortcut or peer RPC) CONCURRENTLY: sequential collection would
        stack per-node timeouts AND give each node a disjoint sampling
        window — cross-node straggler comparison needs one window."""
        results: Dict[str, Any] = {}

        def one(info, hexid):
            try:
                results[hexid] = self._peer_stats(
                    info, what, timeout=timeout_s + 15.0)
            except Exception:   # noqa: BLE001 — a dead peer is a gap
                results[hexid] = None

        threads = []
        for info in self.gcs.alive_nodes():
            hexid = info.node_id.hex()[:12]
            results[hexid] = None    # visible even if its thread hangs
            t = threading.Thread(target=one, args=(info, hexid),
                                 daemon=True, name="rtpu-debug-node")
            t.start()
            threads.append(t)
        deadline = time.monotonic() + timeout_s + 20.0
        for t in threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        return results

    def cluster_stacks(self, timeout_s: float = 5.0) -> dict:
        """Cluster-wide `rtpu stack`: every node's dumps, deduplicated
        by the control plane (``gcs.aggregate_stacks``)."""
        from .gcs import aggregate_stacks
        per_node = {hexid: dumps or []
                    for hexid, dumps in self._collect_nodes_debug(
                        ("stacks", timeout_s), timeout_s).items()}
        n_procs = sum(len(d) for d in per_node.values())
        self.events.info("DEBUG_STACKS",
                         "collected cluster-wide stack dump",
                         nodes=len(per_node), processes=n_procs)
        return {"nodes": per_node, "groups": aggregate_stacks(per_node)}

    def cluster_profile(self, opts: dict) -> dict:
        """Cluster-wide sampling profile: every node's worker reports
        plus merged collapsed stacks. All nodes sample the SAME window
        (concurrent fan-out)."""
        from . import debugging
        duration = min(float(opts.get("duration_s") or 5.0),
                       CONFIG.profiler_max_duration_s)
        per_node = {}
        reports: List[dict] = []
        for hexid, reps in self._collect_nodes_debug(
                ("profile", {**opts, "duration_s": duration}),
                duration + 15.0).items():
            per_node[hexid] = reps or []
            reports.extend(reps or [])
        collapsed = debugging.merge_collapsed(reports)
        self.events.info("DEBUG_PROFILE",
                         "collected cluster-wide sampling profile",
                         duration_s=duration, workers=len(reports),
                         stacks=len(collapsed))
        return {"nodes": per_node, "collapsed": collapsed,
                "duration_s": duration,
                "num_samples": sum(r.get("num_samples", 0)
                                   for r in reports)}

    def _dispatch_loop(self) -> None:
        while True:
            item = self._events.get()
            # Drain everything already queued: a burst of events (many
            # TASK_DONEs, object seals, submissions from several conns)
            # is handled with ONE scheduling pass and one outbox flush,
            # not one per event — the cross-event extension of the
            # SUBMIT_BATCH burst hook. Bounded so ticks/outbox flushes
            # keep their cadence under sustained load.
            batch: Optional[list] = None
            budget = CONFIG.dispatcher_event_batch - 1
            while budget > 0:
                try:
                    nxt = self._events.get_nowait()
                except queue.Empty:
                    break
                if batch is None:
                    batch = [item]
                batch.append(nxt)
                budget -= 1
            if batch is None:
                if item[0] == "stop":
                    return
                try:
                    self._handle(item)
                except Exception:
                    import traceback
                    traceback.print_exc(file=sys.stderr)
                finally:
                    self._flush_outboxes()
                continue
            stop = False
            prev = self._in_batch
            self._in_batch = True
            try:
                for it in batch:
                    if it[0] == "stop":
                        stop = True
                        break
                    try:
                        self._handle(it)
                    except Exception:
                        import traceback
                        traceback.print_exc(file=sys.stderr)
            finally:
                self._in_batch = prev
            if not stop:
                try:
                    self._dispatch()
                except Exception:
                    import traceback
                    traceback.print_exc(file=sys.stderr)
            self._flush_outboxes()
            if stop:
                return

    def _send_execute(self, w: _Worker, item: tuple) -> None:
        """Queue an EXECUTE for this worker; coalesced per event."""
        self._exec_outbox.setdefault(w.worker_id, []).append(item)

    # concurrency: dispatcher-only
    def _flush_outboxes(self) -> None:
        if self._exec_outbox:
            self._flush_exec_outbox()
        if self._reply_outbox:
            self._flush_reply_outbox()

    def _flush_exec_outbox(self) -> None:
        outbox, self._exec_outbox = self._exec_outbox, {}
        for wid, items in outbox.items():
            w = self._workers.get(wid)
            if w is None or w.conn is None:
                continue
            try:
                if len(items) == 1:
                    w.conn.send((P.EXECUTE_TASK, items[0]))
                else:
                    w.conn.send((P.EXECUTE_BATCH, items))
            except OSError:
                self._events.put(("conn_closed", w.conn_key))

    # concurrency: dispatcher-only
    def _reply_batched(self, conn_key: int, op: int, payload: Any) -> None:
        """Reply from a DISPATCHER-thread path: buffered per connection
        and flushed as one ordered burst at the end of the current event
        batch — a storm of GET_REPLYs costs the client one frame and one
        reader wakeup instead of one each. Zero added latency: the flush
        happens before the dispatcher sleeps again. Reader/debug threads
        must keep using _reply (direct, thread-safe)."""
        self._reply_outbox.setdefault(conn_key, []).append((op, payload))

    def _flush_reply_outbox(self) -> None:
        outbox, self._reply_outbox = self._reply_outbox, {}
        for key, msgs in outbox.items():
            conn = self._conns.get(key)
            if conn is None:
                continue
            try:
                conn.send_many(msgs)
            except OSError:
                pass

    # ------------------------------------------------------------- handling
    # concurrency: dispatcher-only
    def _handle(self, item: tuple) -> None:
        kind = item[0]
        if kind == "msg":
            _, key, (op, payload) = item
            self._handle_msg(key, op, payload)
        elif kind == "msgs":
            self._handle_burst(item[1], item[2])
        elif kind == "conn_closed":
            self._on_conn_closed(item[1])
        elif kind == "remote_task":
            self._queue_local(item[1], "task")
        elif kind == "remote_actor_create":
            self._local_create_actor(item[1])
        elif kind == "remote_actor_task":
            self._local_actor_task(item[1])
        elif kind == "remote_kill_actor":
            self._local_kill_actor(item[1], item[2])
        elif kind == "remote_cancel":
            self._local_cancel(item[1], item[2])
        elif kind == "object_ready":
            self._on_object_ready(item[1], item[2])
        elif kind == "node_dead":
            self._on_node_dead(item[1])
        elif kind == "task_finished":
            owned = self._owned.pop(item[1], None)
            if owned is not None:
                # we were the submitter: release the task's arg pins
                try:
                    self.gcs.unpin_task_args(item[1])
                except Exception:
                    pass
        elif kind == "ref_zero":
            self._local_ref_zero(item[1], item[2])
        elif kind == "actor_dead":
            self._on_remote_actor_dead(item[1], item[2])
        elif kind == "actor_reroute":
            self._reroute_actor(item[1])
        elif kind == "actor_parked_flush":
            self._flush_parked_actor_calls(item[1])
        elif kind == "spillback_task":
            self._on_spillback_task(item[1], item[2])
        elif kind == "gen_event":
            self._on_gen_event(item[1])
        elif kind == "timer":
            item[1]()

    # concurrency: dispatcher-only
    def _handle_burst(self, key: int, msgs: List[tuple]) -> None:
        """One receive burst from one connection, handled with a single
        scheduling pass at the end (mirrors SUBMIT_BATCH): a burst of
        TASK_DONEs frees N workers then dispatches once, not N times."""
        if len(msgs) == 1:
            self._handle_msg(key, *msgs[0])
            return
        prev = self._in_batch
        self._in_batch = True
        try:
            for op, payload in msgs:
                try:
                    self._handle_msg(key, op, payload)
                except Exception:
                    import traceback
                    traceback.print_exc(file=sys.stderr)
        finally:
            self._in_batch = prev
        if not self._in_batch:
            self._dispatch()

    # concurrency: dispatcher-only
    def _handle_msg(self, key: int, op: int, payload: Any) -> None:
        if op == P.REGISTER:
            kind, worker_id, pid = payload
            self._conn_kind[key] = kind
            # collective endpoint route for this process (drivers too)
            self._coll_conns[bytes(worker_id)] = self._conns[key]
            self._conn_coll_wid[key] = bytes(worker_id)
            if kind == P.KIND_WORKER:
                wid = WorkerID(worker_id)
                self._conn_worker[key] = wid
                w = self._workers.get(wid)
                if w is None:
                    w = _Worker(worker_id=wid)
                    self._workers[wid] = w
                w.conn = self._conns[key]
                w.conn_key = key
                w.pid = pid
                self._num_starting = max(0, self._num_starting - 1)
                self._env_spawn_failures.pop(w.env_key, None)
                if w.state == "STARTING":
                    self._mark_idle(w)
                if not self._in_batch:
                    self._dispatch()
            else:
                self._driver_conn_keys.add(key)
        elif op == P.SUBMIT_TASK:
            self._submit_task(payload)
        elif op == P.SUBMIT_BATCH:
            # coalesced submissions: queue them all, then dispatch once —
            # a 100-task burst is one scheduling pass, not 100.
            # Save/restore: this frame may itself arrive inside a
            # transport burst (_handle_burst) that defers the dispatch.
            telemetry.hist_observe(telemetry.M_SUBMIT_BATCH,
                                   float(len(payload)), self._mtags)
            prev = self._in_batch
            self._in_batch = True
            try:
                for sub_op, spec in payload:
                    self._handle_msg(key, sub_op, spec)
            finally:
                self._in_batch = prev
            if not self._in_batch:
                self._dispatch()
        elif op == P.CREATE_ACTOR:
            self._create_actor(payload)
        elif op == P.SUBMIT_ACTOR_TASK:
            self._submit_actor_task(payload)
        elif op == P.NOTIFY_BLOCKED:
            self._worker_blocked(key)
        elif op == P.RETURN_LEASED:
            self._on_return_leased(key, payload)
        elif op == P.NOTIFY_UNBLOCKED:
            self._worker_unblocked(key)
        elif op == P.SET_LOG_LABEL:
            wid = self._conn_worker.get(key)
            w = self._workers.get(wid) if wid is not None else None
            if w is not None:
                w.log_label = str(payload)[:64]
        elif op == P.PROFILE_EVENT:
            ev_kind, ev_payload = payload
            if ev_kind == "spans":
                try:
                    self.gcs.record_spans(ev_payload)
                except Exception:   # noqa: BLE001 — tracing is best-effort
                    pass
            elif ev_kind == "metrics":
                try:
                    self.gcs.record_metrics(ev_payload)
                except Exception:   # noqa: BLE001 — telemetry best-effort
                    pass
            elif ev_kind == "coll_reform":
                # a rank process (worker/driver) reformed its collective
                # group; it has no EventLogger of its own, so the
                # literal emit lives here
                try:
                    fields = {k: v for k, v in dict(ev_payload).items()
                              if k != "message"}
                    self.events.warning(
                        "COLLECTIVE_REFORM",
                        str(ev_payload.get("message",
                                           "collective group reformed")),
                        **fields)
                except Exception:   # noqa: BLE001 — accounting only
                    pass
            elif ev_kind == "debug_bundle":
                # a driver/worker captured a post-mortem bundle; it has
                # no EventLogger, so the literal emit lives here
                try:
                    rec = dict(ev_payload)
                    msg = str(rec.pop("message", "debug bundle captured"))
                    self.events.info("DEBUG_BUNDLE", msg, **rec)
                except Exception:   # noqa: BLE001 — accounting only
                    pass
            elif ev_kind == "serve_request":
                # a serve replica promoted a slow/failed request; the
                # replica worker has no EventLogger, so the literal
                # emit lives here (labels stay statically lintable)
                try:
                    rec = dict(ev_payload)
                    req_kind = rec.pop("kind", "slow")
                    msg = str(rec.pop("message", "serve request"))
                    if req_kind == "error":
                        self.events.warning("REQUEST_ERROR", msg, **rec)
                    else:
                        self.events.warning("SLOW_REQUEST", msg, **rec)
                except Exception:   # noqa: BLE001 — accounting only
                    pass
        elif op == P.GET_OBJECTS:
            self._get_objects(key, *payload)
        elif op == P.GET_OBJECTS_FETCH:
            self._get_objects(key, *payload, fetch=True)
        elif op == P.WAIT_OBJECTS:
            self._wait_objects(key, *payload)
        elif op == P.FREE_OBJECTS:
            for oid in payload:
                self.gcs.drop_location(oid)
            self.store.free(payload)
        elif op == P.TASK_DONE:
            self._task_done(key, *payload)
        elif op == P.GEN_ITEM:
            self._gen_item(*payload)
        elif op == P.GEN_NEXT:
            self._gen_next(key, *payload)
        elif op == P.GEN_CLOSE:
            self._gen_close(payload[0])
        elif op == P.KILL_ACTOR:
            self._kill_actor(*payload)
        elif op == P.CANCEL_TASK:
            self._cancel_task(*payload)
        elif op == P.GET_NAMED_ACTOR:
            req_id, name, namespace = payload
            rec = self.gcs.lookup_named_actor(name, namespace)
            info = None
            if rec is not None and rec.state != ACTOR_DEAD:
                info = {"actor_id": rec.spec.actor_id,
                        "name": rec.spec.name,
                        "is_async": rec.spec.is_async,
                        "max_concurrency": rec.spec.max_concurrency}
            self._reply(key, P.NAMED_ACTOR_REPLY, (req_id, info))
        elif op == P.KV_PUT:
            k, v, overwrite = payload
            self.gcs.kv_put(k, v, overwrite)
        elif op == P.KV_GET:
            req_id, k = payload
            self._reply(key, P.KV_REPLY, (req_id, self.gcs.kv_get(k)))
        elif op == P.KV_DEL:
            self.gcs.kv_del(payload)
        elif op == P.KV_KEYS:
            req_id, prefix = payload
            self._reply(key, P.KV_REPLY, (req_id, self.gcs.kv_keys(prefix)))
        elif op == P.FETCH_FUNCTION:
            req_id, function_id = payload
            blob = self.gcs.kv_get(b"fn:" + function_id)
            self._reply(key, P.FUNCTION_REPLY, (req_id, blob))
        elif op == P.CLUSTER_INFO:
            req_id, what = payload
            self._reply(key, P.INFO_REPLY, (req_id, self._cluster_info(what)))
        elif op == P.CREATE_PG:
            self._create_pg(key, payload)
        elif op == P.REMOVE_PG:
            self._remove_pg(payload)
        elif op == P.ACTOR_EXIT:
            actor_id, reason = payload
            self._local_kill_actor(actor_id, True, reason=reason or "exit_actor")
        elif op == P.ACTOR_CHECKPOINT:
            req_id, actor_id, seq, blob = payload
            try:
                # the plane's monotonic seq-guard verdict goes BACK to
                # the worker: a rejected (stale) save must not read as
                # durable there
                ok = self.gcs.save_actor_checkpoint(actor_id, int(seq),
                                                    bytes(blob))
            except Exception as e:  # noqa: BLE001 — the worker blocks
                self._reply(key, P.ERROR_REPLY, (req_id, to_bytes(e)))
            else:
                self._reply(key, P.INFO_REPLY, (req_id, ok))
        elif op == P.ACTOR_CHECKPOINT_GET:
            req_id, actor_id = payload
            try:
                ckpt = self.gcs.get_actor_checkpoint(actor_id)
            except Exception:   # noqa: BLE001 — a miss restores nothing
                ckpt = None
            self._reply(key, P.INFO_REPLY, (req_id, ckpt))
        elif op == P.STATE_QUERY:
            req_id, what, filters = payload
            self._reply(key, P.INFO_REPLY,
                        (req_id, self._state_query(what, filters)))
        elif op == P.REF_REGISTER:
            self._apply_ref_edge(key, op, payload)
        elif op == P.REF_DROP:
            self._apply_ref_edge(key, op, payload)
        elif op == P.REF_BATCH:
            for edge_op, oid in payload:
                self._apply_ref_edge(key, edge_op, oid)
        elif op == P.RETURN_REFS:
            holder_oid, contained = payload
            try:
                self.gcs.pin_contained(holder_oid, contained)
            except Exception:   # noqa: BLE001 — best-effort, like edges
                pass
        elif op == P.OBJ_PROVENANCE:
            try:
                self.gcs.record_provenance(payload)
            except Exception:   # noqa: BLE001 — attribution is best-effort
                pass

    def _reply(self, conn_key: int, op: int, payload: Any) -> None:
        conn = self._conns.get(conn_key)
        if conn is None:
            return
        try:
            conn.send((op, payload))
        except OSError:
            pass

    # ----------------------------------------------------------- submission
    def _debit_route(self, target: NodeID, resources: Dict[str, float]) -> None:
        """Remember resources just routed to a peer so the next routing
        decision doesn't see them as still free (gossiped availability
        lags by up to a heartbeat). Each debit records the peer's
        resource VERSION at routing time: a later snapshot (version
        advanced) already reflects the routed task — as lowered
        availability or as a gossiped pending shape — so the debit
        expires on version advance, not only on the wall-clock TTL. A
        fixed TTL alone double-counted: a burst arriving ~1-2s after a
        previous one saw the peers' fresh free view MINUS the previous
        burst's still-live debits and herded everything onto the local
        node (the burst-balance root cause)."""
        if resources:
            self._route_debits.setdefault(target, []).append(
                (time.monotonic(), resources,
                 self._node_versions.get(target)))

    def _candidates(self):
        out = []
        now = time.monotonic()
        ttl = CONFIG.scheduler_route_debit_ttl_s
        seen = set()
        for info in self.gcs.alive_nodes():
            seen.add(info.node_id)
            svc = info.service
            if svc is not None:
                if svc.dead:
                    continue
                # same-process node: availability is exact up to its
                # QUEUE — available_snapshot only reflects dispatched
                # tasks, so during a deferred-dispatch SUBMIT_BATCH the
                # whole burst read "2 CPUs free" here and herded onto
                # this node, leaving spillback to clean up a wave later
                # (the burst-balance flake's root cause).
                # Queued-but-undispatched demand is capacity already
                # spoken for: subtract it like a debit that self-clears
                # the instant the task dispatches.
                avail = svc.available_snapshot()
                for shape in svc.pending_demand():
                    for k, v in shape.items():
                        avail[k] = avail.get(k, 0.0) - v
                # a task routed to an in-process peer is visible in
                # NEITHER its snapshot NOR its pending queue until its
                # dispatcher drains the post_remote event — a burst
                # routed within that window dogpiled the first free
                # peer. Subtract only YOUNG debits: once the
                # task lands in the peer's pending view (~ms) the
                # pending subtraction above takes over, and a long TTL
                # here would double-count it
                for ts, res, _ver in self._prune_debits(info.node_id,
                                                        now, ttl):
                    if now - ts < min(ttl, 0.25):
                        for k, v in res.items():
                            avail[k] = avail.get(k, 0.0) - v
            else:
                # remote process: availability from heartbeat gossip
                # (RaySyncer-equivalent); subtract what we routed there
                # within the debit ttl so a burst doesn't herd onto one
                # node through the stale view, plus the node's own
                # gossiped queued demand (capacity spoken for by tasks
                # other drivers routed there)
                avail = dict(info.resources_available
                             or info.resources_total)
                for shape in info.pending_shapes or ():
                    for k, v in shape.items():
                        avail[k] = avail.get(k, 0.0) - v
                for _ts, res, _ver in self._prune_debits(
                        info.node_id, now, ttl,
                        current_version=info.resource_version):
                    for k, v in res.items():
                        avail[k] = avail.get(k, 0.0) - v
            self._node_versions[info.node_id] = info.resource_version
            out.append((info.node_id, dict(info.resources_total), avail))
        # nodes that left the cluster take their debit history with them
        for nid in list(self._route_debits):
            if nid not in seen:
                del self._route_debits[nid]
        return out

    def _prune_debits(self, nid: NodeID, now: float, ttl: float,
                      current_version: Optional[int] = None) -> list:
        """Drop expired debits: past the wall-clock TTL, or (remote
        gossip) superseded by a snapshot newer than the one the debit
        was taken against."""
        debits = self._route_debits.get(nid)
        if not debits:
            return []
        live = [(ts, res, ver) for ts, res, ver in debits
                if now - ts < ttl
                and (current_version is None or ver is None
                     or current_version <= ver
                     # a version bump within the submit's own flight
                     # window may predate the task's arrival at the
                     # peer — only trust version expiry once the debit
                     # is old enough for the task to have landed
                     or now - ts < 0.25)]
        if live:
            self._route_debits[nid] = live
        else:
            del self._route_debits[nid]
        return live

    def _peer(self, node_id: NodeID):
        """Handle to a node: self, an in-process NodeService, or a
        _RemotePeer over TCP. None if the node is dead/unreachable."""
        if node_id == self.node_id:
            return self
        info = self.gcs.get_node(node_id)
        if info is None or not info.alive:
            return None
        if info.service is not None:
            return None if info.service.dead else info.service
        rp = self._peers.get(node_id)
        if rp is None or rp.closed:
            try:
                rp = _RemotePeer(self, info)
            except OSError:
                return None
            self._peers[node_id] = rp
        return rp

    def _peer_store(self, node_id: NodeID):
        """The object-plane surface of a peer (get_meta / pin_and_get /
        unpin): the in-process store, or the _RemotePeer itself."""
        peer = self._peer(node_id)
        if peer is None:
            return None
        return peer.store if isinstance(peer, NodeService) else peer

    @staticmethod
    def _arg_refs(spec: P.TaskSpec) -> List[ObjectID]:
        return [val for slot, val in
                list(spec.args) + list(spec.kwargs.values()) if slot == "r"]

    def _pin_submission(self, task_id: TaskID, arg_refs: List[ObjectID],
                        spec: Optional[P.TaskSpec] = None) -> None:
        """Submitted-task references + lineage recording at submission
        (reference: reference_count.h submitted-task refs;
        task lineage, ``task_manager.h:369``). Pins carry this node as
        owner so the control plane can release them if we die."""
        try:
            if arg_refs:
                self.gcs.pin_task_args(task_id, arg_refs,
                                       owner_node=self.node_id)
            if spec is not None and spec.function_id:
                self.gcs.record_lineage(spec)
        except Exception:
            pass

    def _submit_task(self, spec: P.TaskSpec) -> None:
        telemetry.counter_inc(telemetry.M_TASKS_SUBMITTED, 1.0, self._mtags)
        self._owned[spec.task_id] = _OwnedTask(
            spec=spec, kind="task", retries_left=spec.max_retries)
        self._pin_submission(spec.task_id, self._arg_refs(spec), spec)
        self._route_task(spec)

    def _route_task(self, spec: P.TaskSpec,
                    exclude: Optional[Set[NodeID]] = None) -> None:
        strategy = spec.scheduling_strategy
        if isinstance(strategy, sched.PlacementGroupSchedulingStrategy):
            target = self._pg_target_node(strategy)
        else:
            cands = self._candidates()
            if exclude:
                filtered = [c for c in cands if c[0] not in exclude]
                cands = filtered or cands
            target = sched.pick_node(spec.resources, strategy or sched.DEFAULT,
                                     cands, self.node_id, self._rng)
            if _PIPE_DEBUG:
                _pdbg(f"route {spec.task_id.hex()[:8]} "
                      f"{spec.resources} -> "
                      f"{target.hex()[:6] if target else None} cands="
                      + " ".join(f"{nid.hex()[:6]}:{av}"
                                 for nid, _tot, av in cands))
        owned = self._owned.get(spec.task_id)
        if target is None:
            if self._park_infeasible("task", spec):
                # visible to the state API and the stall detector, which
                # diagnoses the unsatisfiable-shape cause from the
                # resources carried in the event
                self._record_event(spec, "PENDING_NODE_ASSIGNMENT")
            else:
                self._fail_returns(spec, RuntimeError(
                    f"no feasible node for resources {spec.resources}"))
            return
        if owned:
            owned.assigned_node = target
            self._record_task_origin(spec.task_id, target)
        # a starved target spills the task back here for re-routing
        spec.origin_node_id = self.node_id.binary()
        if target == self.node_id:
            self._queue_local(spec, "task")
        else:
            peer = self._peer(target)
            if peer is None:
                # the node list still names a node whose connection is
                # gone (its death not yet noticed): route among the others
                # where the strategy allows another node, as it will once
                # the death is noticed; a hard affinity to it, or a
                # placement group's bundle on it, fails here, and so does
                # a target already excluded (nothing else was left)
                excl = set(exclude or ()) | {target}
                pinned = (isinstance(strategy,
                                     sched.PlacementGroupSchedulingStrategy)
                          or (isinstance(strategy,
                                         sched.NodeAffinitySchedulingStrategy)
                              and not strategy.soft))
                if (not pinned and target not in (exclude or ())
                        and any(c[0] not in excl
                                for c in self._candidates())):
                    self._route_task(spec, excl)
                    return
                self._fail_returns(spec, exceptions.WorkerCrashedError(
                    "target node died before dispatch"))
                return
            self._debit_route(target, spec.resources)
            peer.post_remote(("remote_task", spec))

    def _pg_target_node(self, strategy) -> Optional[NodeID]:
        pg = self.gcs.get_pg(strategy.pg_id())
        if pg is None:
            return None
        if pg.get("state") == PG_LOST:
            # journal-restored record: its assignment names nodes that
            # died with the previous head
            return None
        idx = strategy.placement_group_bundle_index
        assignment = pg["assignment"]
        if idx is None or idx < 0:
            idx = 0
        if idx >= len(assignment):
            return None
        return assignment[idx]

    # concurrency: dispatcher-only
    def _queue_local(self, spec: P.TaskSpec, kind: str,
                     actor_spec: Optional[P.ActorSpec] = None) -> None:
        rec = _TaskRecord(spec=spec, kind=kind, actor_spec=actor_spec,
                          retries_left=spec.max_retries,
                          oom_retries_left=CONFIG.task_oom_retries_default)
        if spec.num_returns == -1:
            # the stream will produce HERE: a local record from the
            # start means even pre-first-item end-probes skip the head
            # (same-socket order puts this before any consumer GEN_NEXT)
            self._gen_local.setdefault(
                spec.task_id, {"produced": 0, "done": False,
                               "count": None, "error": None})
        strategy = spec.scheduling_strategy
        if isinstance(strategy, sched.PlacementGroupSchedulingStrategy):
            rec.pg_key = (strategy.pg_id(),
                          max(strategy.placement_group_bundle_index, 0))
        # resolve dependencies first so the event carries the unmet ones
        # (the stall detector diagnoses "blocked on a never-ready
        # object" from exactly this field)
        for slot, val in list(spec.args) + list(spec.kwargs.values()):
            if slot == "r":
                self._add_dep(rec, val)
        self._record_event(spec, "PENDING_ARGS_AVAIL",
                           pending_args=(list(rec.remaining_deps) or None))
        if rec.remaining_deps:
            self._waiting_deps[spec.task_id] = rec
        else:
            self._pending.append(rec)
            if not self._in_batch:
                self._dispatch()

    def _add_dep(self, rec: _TaskRecord, oid: ObjectID) -> None:
        meta = self._lookup_object(oid)
        if meta is not None:
            rec.deps[oid] = meta
        else:
            rec.remaining_deps.add(oid)
            self._dep_index.setdefault(oid, set()).add(rec.spec.task_id)
            self._maybe_reconstruct(oid)

    def _pin_deps(self, rec: "_TaskRecord") -> None:
        """Pin every dependency at its *owning* store just before dispatch,
        refreshing the meta so the worker never reads a segment the owner
        spilled between dep resolution and execution (reference analogue:
        raylet ``PinObjectIDs``, ``node_manager.proto:388``)."""
        for oid in list(rec.deps):
            store = self._owning_store(oid)
            if store is None:
                continue
            fresh = store.pin_and_get(oid)
            if fresh is not None:
                rec.deps[oid] = fresh
                rec.pinned_stores[oid] = store

    def _unpin_deps(self, rec: "_TaskRecord") -> None:
        # Unpin exactly the stores pinned at dispatch — the directory may
        # have changed (e.g. free()) while the task ran.
        for oid, store in rec.pinned_stores.items():
            store.unpin(oid)
        rec.pinned_stores = {}

    def _owning_store(self, oid: ObjectID):
        """The object-plane handle holding the primary copy: our store,
        the owning node's store (in-process cluster), or a _RemotePeer
        (network plane)."""
        if self.store.contains(oid):
            return self.store
        loc = self.gcs.lookup_location(oid)
        if loc is None:
            return None
        return self._peer_store(loc[0])

    # ------------------------------------------ refcount + reconstruction
    def _holder_id(self, conn_key: int) -> tuple:
        return (self.node_id.binary(), conn_key)

    def _apply_ref_edge(self, key: int, op: int, oid: ObjectID) -> None:
        refs = self._conn_refs.setdefault(key, set())
        try:
            if op == P.REF_REGISTER:
                if oid not in refs:
                    refs.add(oid)
                    self.gcs.ref_register(oid, self._holder_id(key))
            elif oid in refs:
                refs.discard(oid)
                self.gcs.ref_drop(oid, self._holder_id(key))
        except Exception:
            pass

    def _on_ref_zero(self, payload) -> None:
        self._events.put(("ref_zero", payload["object_id"],
                          payload["node_id"]))

    def _local_ref_zero(self, oid: ObjectID,
                        owner_node: Optional[NodeID]) -> None:
        """No process holds a reference and no task uses the object:
        free our copy (primary or pulled secondary). Arena blocks whose
        bytes were ever read go through the free-quarantine."""
        if owner_node == self.node_id:
            self.gcs.drop_location(oid)
        if self.store.contains(oid):
            self.store.free([oid])

    def _maybe_reconstruct(self, oid: ObjectID) -> bool:
        """Lost object with recorded lineage: resubmit its creating task
        (reference: ``object_recovery_manager.h:90``). Returns True if a
        reconstruction is (already) in flight. The control plane's
        claim_lineage is the gate: it hands out the spec only when the
        object was sealed once and is now locationless, to exactly one
        claimant — so in-flight first executions and concurrent
        reconstructions are never duplicated."""
        if oid in self._reconstructing:
            return True
        if self.store.contains(oid):
            return False
        try:
            spec = self.gcs.claim_lineage(oid)
        except Exception:
            return False
        if spec is None:
            return False
        if spec.task_id in self._owned:
            return True         # resubmission already in flight locally
        self._reconstructing.update(spec.return_ids)
        self._owned[spec.task_id] = _OwnedTask(
            spec=spec, kind="task", retries_left=spec.max_retries)
        self._pin_submission(spec.task_id, self._arg_refs(spec))
        # creating-task args may themselves be lost: recurse
        for dep in self._arg_refs(spec):
            if not self._object_exists(dep):
                self._maybe_reconstruct(dep)
        self._route_task(spec)
        return True

    def _object_exists(self, oid: ObjectID) -> bool:
        """Existence probe for wait()/readiness checks: metadata only,
        never pulls a cross-host payload (that happens at read time)."""
        if self.store.contains(oid):
            return True
        tid = TaskID(TaskID.KIND + oid.binary()[:15])
        owned = self._owned.get(tid)
        if owned is not None and not owned.done:
            # our own still-running task: its returns exist nowhere yet
            # — park without a head directory round trip (owner-based
            # resolution; the completion event resolves the waiter)
            return False
        origin = self._task_origin.get(tid)
        if origin is not None and origin != self.node_id:
            remote = self._peer_store(origin)
            if remote is not None and remote is not self.store:
                try:
                    if remote.get_meta(oid) is not None:
                        return True
                except Exception:   # noqa: BLE001 — head fallback below
                    pass
        loc = self.gcs.lookup_location(oid)
        if loc is None:
            return False
        handle = self._peer_store(loc[0])
        if handle is None:
            # owner unreachable; the directory-shared meta is the best
            # evidence (an actual get will pull or fail loudly)
            return loc[1].has_value()
        if isinstance(handle, _RemotePeer):
            return handle.peek(oid) is not None
        return handle.get_meta(oid) is not None

    def _record_task_origin(self, task_id: TaskID, node_id: NodeID
                            ) -> None:
        self._task_origin[task_id] = node_id
        self._task_origin.move_to_end(task_id)
        while len(self._task_origin) > 8192:
            self._task_origin.popitem(last=False)

    def _lookup_object(self, oid: ObjectID) -> Optional[ObjectMeta]:
        meta = self.store.get_meta(oid)
        if meta is not None:
            return meta
        # owner-based resolution first (reference:
        # ownership_based_object_directory.h): we submitted the creating
        # task, so we know which node sealed its returns — read straight
        # from that store, no head directory RTT. Miss (freed, moved,
        # reconstructed elsewhere) falls back to the head.
        origin = self._task_origin.get(
            TaskID(TaskID.KIND + oid.binary()[:15]))
        if origin is not None and origin != self.node_id:
            remote = self._peer_store(origin)
            if remote is not None and remote is not self.store:
                try:
                    meta = remote.get_meta(oid)
                except Exception:   # noqa: BLE001 — peer gone; head
                    meta = None     # fallback resolves or fails cleanly
                if meta is not None:
                    return meta
        loc = self.gcs.lookup_location(oid)
        if loc is None:
            return None
        nid, meta = loc
        remote = self._peer_store(nid)
        if remote is not None and remote is not self.store:
            # Always route cross-node reads through the owning store:
            # get_meta marks the entry read (ever_read) and restores
            # spilled entries, so the owner will never spill-and-free an
            # arena block whose bytes a remote reader's zero-copy views
            # still alias. Returning the directory-shared meta directly
            # bypassed that tracking (silent corruption under memory
            # pressure). Reference analogue: reads go through the primary
            # raylet's plasma store / RestoreSpilledObjects
            # (``local_object_manager.h:110``).
            return remote.get_meta(oid)
        if (meta.shm_name is None and meta.inline is None
                and meta.error is None and meta.arena_ref is None):
            return None
        return meta

    # ------------------------------------------------------------- dispatch
    # concurrency: dispatcher-only
    def _dispatch(self) -> None:
        """Scan the local queue, dispatching every task whose resources and
        worker are available (reference:
        ``LocalTaskManager::DispatchScheduledTasksToWorkers``,
        ``local_task_manager.cc:105``)."""
        if not self._pending:
            return
        failed_envs: Set[str] = set()
        starved_envs: Set[str] = set()
        for shape in self._pending.shapes():
            env_key = shape[2]
            bucket = self._pending.bucket(shape)
            exhausted = False
            while bucket:
                rec = bucket[0]
                if rec.cancelled:
                    self._pending.popleft(shape)
                    continue
                if not self._try_acquire(rec):
                    exhausted = True
                    break                # this shape doesn't fit right now
                gpus = rec.accel_ids
                wkey = _worker_key(env_key, gpus)
                if wkey in starved_envs:
                    # spawn already requested this pass for this env;
                    # don't rescan the idle deque per bucket
                    self._release_charge(rec)
                    self._maybe_spawn_worker(rec, gpus)
                    break
                wid = self._acquire_worker(wkey)
                if wid is None:
                    self._release_charge(rec)
                    if (self._env_spawn_failures.get(wkey, 0)
                            >= CONFIG.worker_startup_max_failures):
                        failed_envs.add(wkey)
                        # workers for this env die on startup repeatedly —
                        # fail fast instead of pending forever (reference:
                        # PopWorker status callback, ``worker_pool.h:152``)
                        self._pending.popleft(shape)
                        self._fail_pending_rec(
                            rec, exceptions.RuntimeEnvSetupError(
                                f"workers for task {rec.spec.name!r} "
                                f"failed to start "
                                f"{CONFIG.worker_startup_max_failures} "
                                "times; last worker log tail:\n"
                                + self._env_spawn_error.get(
                                    wkey, "<no log>")))
                        continue
                    starved_envs.add(wkey)
                    # parallel cold-start ramp: request a spawn per
                    # starved task up to the startup-concurrency cap —
                    # one spawn per dispatch pass would serialize a
                    # burst's ramp-up behind single worker cold-starts
                    if gpus:
                        self._spawn_for_slot_sets(bucket, gpus)
                    else:
                        for _ in range(min(
                                len(bucket),
                                CONFIG.maximum_startup_concurrency)):
                            self._maybe_spawn_worker(rec)
                    # a different-env shape behind this one may still
                    # have an idle worker; move to the next bucket
                    break
                self._pending.popleft(shape)
                self._assign(rec, wid)
            if bucket and (exhausted or self._num_starting == 0):
                # lease extra tasks onto busy workers only when no new
                # worker is coming: capacity is the binding constraint
                # (exhausted), or the pool/startup cap blocked spawning
                # (nothing STARTING even after the spawn attempts above
                # — the num_cpus=0 burst regime). When workers are
                # merely cold-starting, DON'T pipe: it would park a
                # task behind a possibly-long running one (head-of-line
                # blocking) when a spawning worker could serve it in
                # milliseconds.
                self._pipeline_into_busy(shape, bucket)
            self._pending.drop_empty(shape)
        # fresh budget for future submissions: the blacklist applies to
        # tasks pending in this pass, not to the env forever
        for env in failed_envs:
            self._env_spawn_failures.pop(env, None)

    def _pipeline_into_busy(self, shape: tuple, bucket: deque) -> None:
        """Lease extra same-shape tasks onto workers already running that
        shape, up to a small depth (reference: worker-lease reuse — the
        owner keeps pushing tasks to a leased worker instead of paying a
        scheduler round trip per task, ``direct_task_transport.h``).
        Piped tasks hold NO resource charge: the worker executes
        serially, so only its running task consumes resources; the
        charge transfers on each completion (identical shape). Excluded:
        placement groups (per-bundle pools) and GPU tasks (exclusive
        accelerator slot ids differ per task)."""
        depth = CONFIG.worker_pipeline_depth
        pg_key, res, _env = shape
        if (depth <= 1 or pg_key is not None
                or any(r == "GPU" for r, _ in res)):
            return
        if len(bucket) < 2:
            # the lease-reuse win only pays on task streams; see the
            # matching len(bucket) > 1 condition in the drain loop
            return
        for w in self._workers.values():
            if not bucket:
                break
            if (w.state != "BUSY" or w.conn is None or w.task is None
                    or w.task.kind != "task"
                    or w.task.blocked_depth > 0 or w.blocked_gets
                    or getattr(w.task, "_pending_shape", None) != shape):
                # never lease behind a task blocked in get(): the queue
                # would park until it unblocks (and could BE what it
                # waits on)
                continue
            # drain down to ONE remaining task, never to zero: a piped
            # task leaves _pending — invisible to _spill_starved_pending
            # — so the bucket's last task always stays schedulable/
            # spillback-rescuable instead of starving head-of-line
            # behind a long occupant while another node idles (the
            # burst-audit regression, closed for every bucket
            # size, not just lone tasks)
            while len(bucket) > 1 and len(w.pipeline) + 1 < depth:
                rec = bucket[0]
                if rec.no_pipe or rec.kind != "task":
                    # bounced-once tasks and actor creations (which
                    # share a shape bucket with plain tasks) wait for a
                    # normal assignment
                    break
                self._pending.popleft(shape)
                if rec.cancelled:
                    continue
                rec.worker_id = w.worker_id
                self._running[rec.spec.task_id] = rec
                self._record_event(rec.spec, "RUNNING")
                self._pin_deps(rec)
                rec.spec.accel_ids = None
                w.lease_seq += 1
                rec.lease_seq = w.lease_seq
                w.pipeline.append(rec)
                _pdbg(f"pipe {rec.spec.task_id.hex()[:8]} -> "
                      f"{w.worker_id.hex()[:6]} seq={rec.lease_seq}")
                self._send_execute(w, (rec.kind, rec.spec, rec.deps,
                                       rec.actor_spec, rec.lease_seq))

    def _spill_starved_pending(self) -> None:
        """Re-route queued tasks that have starved locally while another
        node has free capacity (reference: lease spillback,
        ``cluster_task_manager.cc`` — a lease that can't be served locally
        is redirected rather than parked forever). Without this, a stale
        routing view can strand a task behind a long-running occupant
        while the rest of the cluster idles."""
        delay = CONFIG.scheduler_spillback_delay_s
        if delay <= 0 or not self._pending:
            return
        now = time.monotonic()
        cands = None
        spilled = 0
        for shape in self._pending.shapes():
            if spilled >= 10:      # bound per-tick dispatcher work
                break
            bucket = self._pending.bucket(shape)
            if not bucket:
                continue
            rec = bucket[0]
            if (rec.cancelled or rec.pg_key is not None
                    or rec.kind != "task"
                    or now - rec.queued_at < delay):
                continue
            strategy = rec.spec.scheduling_strategy
            if (isinstance(strategy, sched.NodeAffinitySchedulingStrategy)
                    and not strategy.soft):
                continue
            if self._try_acquire(rec):
                # fits locally after all — dispatch will pick it up
                self._release_charge(rec)
                continue
            if cands is None:
                cands = self._candidates()
            fit_now = [(nid, total, avail) for nid, total, avail in cands
                       if nid != self.node_id
                       and sched.fits(avail, rec.spec.resources)]
            if not fit_now:
                continue
            self._pending.remove(rec)
            spilled += 1
            origin = (NodeID(rec.spec.origin_node_id)
                      if rec.spec.origin_node_id else self.node_id)
            if origin == self.node_id:
                # we own the routing decision: re-route, away from here
                self._route_task(rec.spec, exclude={self.node_id})
            else:
                peer = self._peer(origin)
                if peer is None:
                    # origin died; node-death handling owns the retry —
                    # put the task back rather than dropping it
                    self._pending.append(rec)
                    spilled -= 1
                    continue
                peer.post_remote(("spillback_task", rec.spec, self.node_id))

    def _on_spillback_task(self, spec: P.TaskSpec,
                           starved_node: NodeID) -> None:
        """Owner-side: a target couldn't serve a task we routed to it and
        capacity exists elsewhere — route it again, avoiding the starved
        node."""
        owned = self._owned.get(spec.task_id)
        if owned is None or owned.done:
            return                       # completed or cancelled meanwhile
        if owned.assigned_node != starved_node:
            return                       # stale spillback (already moved)
        self._route_task(spec, exclude={starved_node})

    def _fail_pending_rec(self, rec: _TaskRecord, exc: Exception) -> None:
        """Fail a queued (never-dispatched) task record."""
        self._unpin_deps(rec)
        self._record_event(rec.spec, "FAILED")
        # seal the creation/return refs with the root-cause error first;
        # _handle_actor_death below then sees them sealed and won't
        # overwrite with a generic ActorDiedError
        self._fail_returns(rec.spec, exc)
        if rec.kind == "actor_create" and rec.actor_spec is not None:
            aid = rec.actor_spec.actor_id
            st = self._actors.get(aid)
            if st is not None:
                # a restart would hit the same broken env; full death path
                # also drains queued method calls (they'd hang otherwise)
                st["no_restart"] = True
                self._handle_actor_death(aid, str(exc))
            else:
                self.gcs.set_actor_state(aid, ACTOR_DEAD, reason=str(exc))

    def _try_acquire(self, rec: _TaskRecord) -> bool:
        demand = rec.spec.resources
        with self._res_lock:
            if rec.pg_key is not None:
                pool = self.pg_reservations.get(rec.pg_key)
                if pool is None or not sched.fits(pool, demand):
                    return False
                sched.subtract(pool, demand)
            else:
                if not sched.fits(self.resources_available, demand):
                    return False
                sched.subtract(self.resources_available, demand)
            n_gpu = int(demand.get("GPU", 0))
            if n_gpu >= 1:
                if len(self._gpu_free) < n_gpu:
                    # the capacity is back before the slots are: a
                    # placement group removed while its killed actor's
                    # death is still in flight returns its GPU at once,
                    # the actor's slots only with the death. Wait for the
                    # slots; a whole-card demand never runs without them
                    if rec.pg_key is not None:
                        sched.add(self.pg_reservations[rec.pg_key], demand)
                    else:
                        sched.add(self.resources_available, demand)
                    return False
                want = rec.want_gpus
                if not (want and len(want) == n_gpu
                        and all(g in self._gpu_free for g in want)):
                    want = sorted(self._gpu_free)[:n_gpu]
                for g in want:
                    self._gpu_free.remove(g)
                rec.accel_ids = list(want)
        rec.charge = dict(demand)
        return True

    def _release_charge(self, rec: _TaskRecord) -> None:
        if rec.charge is None:
            return
        charge = dict(rec.charge)
        if rec.blocked_depth > 0:
            # the CPU portion was already returned when the worker
            # blocked in get(); releasing it again would mint capacity
            charge.pop("CPU", None)
            rec.blocked_depth = 0
        with self._res_lock:
            pool = self._rec_charge_pool(rec)
            if pool is not None:
                sched.add(pool, charge)
            rec.accel_ids = self._return_gpu_slots(rec.accel_ids)
        rec.charge = None

    # concurrency: requires(node.res)
    def _return_gpu_slots(self, ids) -> None:
        """Return exclusive slot ids to the pool (callers hold
        ``_res_lock``); returns None for assign-back convenience."""
        if ids:
            self._gpu_free.extend(ids)
        return None

    def _rec_charge_pool(self, rec: _TaskRecord):
        if rec.pg_key is not None:
            return self.pg_reservations.get(rec.pg_key)
        return self.resources_available

    def _worker_blocked(self, conn_key: int) -> None:
        """A worker entered a blocking get(): return its CPU so the
        tasks it waits on can be scheduled here — otherwise nested
        submission deadlocks once parents hold every CPU (reference:
        ``NotifyDirectCallTaskBlocked``)."""
        wid = self._conn_worker.get(conn_key)
        w = self._workers.get(wid) if wid is not None else None
        if w is None:
            return
        w.blocked_gets += 1
        rec = w.task
        cpu = rec.charge.get("CPU", 0.0) if (
            rec is not None and rec.charge is not None) else 0.0
        if not cpu:
            # no CPU to return (actor method: the creation holds the
            # charge) — but the pool-cap exemption just changed, and a
            # parked actor creation may now have room to spawn into
            if w.blocked_gets == 1 and not self._in_batch:
                self._dispatch()
            return
        rec.blocked_depth += 1
        if rec.blocked_depth > 1:
            return                  # CPU already returned
        with self._res_lock:
            pool = self._rec_charge_pool(rec)
            if pool is not None:
                sched.add(pool, {"CPU": cpu})
        if not self._in_batch:
            self._dispatch()

    def _on_return_leased(self, conn_key: int, entries: list) -> None:
        """A worker entering a blocking get() handed back its unstarted
        leased tasks (they could be the very children it waits on —
        nested submission would deadlock behind it). The WORKER drained
        its own queue, so it will never run these; requeueing them here
        is double-execution-free by construction.

        Sequenced handshake: each entry is ``(task_id, lease_seq)``
        echoing the seq the grant's EXECUTE carried. A return is
        honored only when the seq matches the task's CURRENT grant on
        THIS worker — a rescue delayed past a re-grant (the task was
        already requeued and dispatched again, here or elsewhere) names
        a superseded seq and is dropped instead of un-assigning the
        live incarnation (the double-dispatch/strand race that kept
        pipelining default-off)."""
        wid = self._conn_worker.get(conn_key)
        w = self._workers.get(wid) if wid is not None else None
        if w is None:
            return
        by_id = {r.spec.task_id: r for r in w.pipeline}
        for tid, seq in entries:
            rec = by_id.get(tid)
            _pdbg(f"return_leased {tid.hex()[:8]} seq={seq} from "
                  f"{w.worker_id.hex()[:6]} found={rec is not None}")
            if rec is not None and rec.lease_seq == seq:
                w.pipeline.remove(rec)
                self._running.pop(tid, None)
                self._unpin_deps(rec)
                rec.worker_id = None
                rec.no_pipe = True
                self._pending.append(rec)
                continue
            if rec is None:
                # handoff raced the bounce: a completion already
                # promoted this lease to w.task (charge and all) while
                # the worker was handing it back — un-assign it here or
                # it stays "running" forever on a worker that never
                # queued it. Only for the SAME grant: a seq mismatch
                # means w.task is a newer grant the worker did accept.
                cur = w.task
                if (cur is not None and cur.spec.task_id == tid
                        and cur.lease_seq == seq):
                    self._running.pop(tid, None)
                    self._unpin_deps(cur)
                    self._release_charge(cur)
                    cur.worker_id = None
                    cur.no_pipe = True
                    if w.state == "BUSY":
                        self._mark_idle(w)
                    self._pending.append(cur)
                    continue
            _pdbg(f"stale rescue dropped {tid.hex()[:8]} seq={seq}")
        if not self._in_batch:
            self._dispatch()

    def _worker_unblocked(self, conn_key: int) -> None:
        wid = self._conn_worker.get(conn_key)
        w = self._workers.get(wid) if wid is not None else None
        if w is None:
            return
        if w.blocked_gets > 0:
            w.blocked_gets -= 1
        rec = w.task
        if rec is None or rec.charge is None or rec.blocked_depth == 0:
            # an idle-but-was-blocked worker became leasable again:
            # pending tasks skipped it while _acquire_worker held it out
            if (w.state == "IDLE" and not w.blocked_gets
                    and self._pending and not self._in_batch):
                self._dispatch()
            return
        rec.blocked_depth -= 1
        if rec.blocked_depth > 0:
            return                  # other threads still blocked
        cpu = rec.charge.get("CPU", 0.0)
        with self._res_lock:
            pool = self._rec_charge_pool(rec)
            if pool is not None:
                # may drive availability transiently negative: the
                # resumed task runs NOW regardless, and new dispatch
                # just waits for real capacity (same oversubscription
                # the reference accepts on unblock)
                sched.subtract(pool, {"CPU": cpu})
        # the pipeliner skipped this worker while blocked_gets > 0;
        # now that it is leasable again, pending same-shape tasks can
        # pipe onto it without waiting for the next completion/tick
        if not w.blocked_gets and self._pending and not self._in_batch:
            self._dispatch()

    def _rec_env_key(self, rec: "_TaskRecord") -> str:
        from . import runtime_env as renv
        spec_env = (rec.actor_spec.runtime_env
                    if rec.actor_spec is not None
                    else rec.spec.runtime_env)
        return renv.env_key(spec_env)

    def _rec_runtime_env(self, rec: "_TaskRecord") -> Optional[dict]:
        return (rec.actor_spec.runtime_env if rec.actor_spec is not None
                else rec.spec.runtime_env)

    def _acquire_worker(self, env_key: str = "") -> Optional[WorkerID]:
        """Pop an idle worker whose runtime env matches (pool keyed by
        env, reference: ``WorkerPool::PopWorker``)."""
        kept = []
        found = None
        while self._idle:
            wid = self._idle.popleft()
            w = self._workers.get(wid)
            if w is None or w.state != "IDLE":
                continue
            if w.blocked_gets:
                # a thread of this worker is still parked in a blocking
                # get(): a grant would only bounce straight back
                # (reader-side rescue) and ping-pong until it unblocks —
                # keep it queued, skip it for now
                kept.append(wid)
                continue
            if w.env_key == env_key:
                found = wid
                break
            kept.append(wid)
        self._idle.extendleft(reversed(kept))
        return found

    def _maybe_spawn_worker(self, rec: Optional["_TaskRecord"] = None,
                            gpus: Optional[List[int]] = None) -> bool:
        """Start a worker for ``rec``'s env (and ``gpus``' slots) where the
        pool allows; True where one is starting, or is bound to those slots
        and can take the task."""
        self._reap_startup_failures()
        env_key = (_worker_key(self._rec_env_key(rec), gpus)
                   if rec is not None else "")
        if gpus and any(w.env_key == env_key
                        and (w.state == "STARTING"
                             or (w.state in ("IDLE", "BUSY")
                                 and not w.blocked_gets))
                        for w in self._workers.values()):
            # slots are exclusive, so one worker bound to them (starting,
            # or ending its last task) takes the task next; a second would
            # import torch and make a CUDA context of its own on the same
            # card, and the idle pool hands tasks out oldest first. One
            # with a thread parked in a get() is not leased, so it does
            # not count
            return True
        # workers blocked in a get() don't count against the pool cap:
        # deep nested submission (recursion) parks a worker per level,
        # and capping on them deadlocks the leaves that would unblock
        # them (reference: WorkerPool grows past the cap while direct
        # call workers are blocked). blocked_gets covers actors too —
        # their method records hold no CPU charge so blocked_depth
        # never rises, but an actor waiting on a nested actor creation
        # (a collective-group coordinator, say) pins its process just
        # the same
        active = sum(1 for w in self._workers.values()
                     if w.state != "DEAD"
                     and not w.blocked_gets
                     and not (w.task is not None
                              and w.task.blocked_depth > 0))
        if active >= self._max_workers:
            # pool full of other-env workers would starve this env forever;
            # evict one idle mismatched worker to make room (reference:
            # WorkerPool idle eviction, ``worker_pool.h:152``)
            if not self._evict_idle_worker(exclude_env=env_key):
                return False
        if self._num_starting >= CONFIG.maximum_startup_concurrency:
            return False
        if rec is not None:
            self._spawn_worker(env_key, self._rec_runtime_env(rec), gpus)
        else:
            self._spawn_worker()
        return True

    def _spawn_for_slot_sets(self, bucket: deque, gpus: List[int]) -> None:
        """Start a worker for each slot set the tasks of a starved GPU
        bucket take, the head task's own ``gpus`` first and then the lowest
        free slots, and have each task keep its set while a worker is bound
        to it. A worker serves only its own slots: without this the second
        task waits for the first one's worker, and where the first task
        ends before another worker is up, takes its freed lower slots and
        runs after it."""
        n = len(gpus)
        with self._res_lock:
            free = sorted(g for g in self._gpu_free if g not in gpus)
        sets = [gpus] + [free[i:i + n] for i in range(0, len(free) - n + 1, n)]
        for rec, ids in zip((r for r in bucket if not r.cancelled), sets):
            rec.want_gpus = ids if self._maybe_spawn_worker(rec, ids) else None

    def _evict_idle_worker(self, exclude_env: str) -> bool:
        """Kill one idle worker whose env differs from ``exclude_env``."""
        for wid in list(self._idle):
            w = self._workers.get(wid)
            if w is None or w.state != "IDLE" or w.env_key == exclude_env:
                continue
            self._kill_worker(wid)
            return True
        return False

    def _kill_worker(self, wid: WorkerID) -> None:
        w = self._workers.pop(wid, None)
        if w is None:
            return
        try:
            self._idle.remove(wid)
        except ValueError:
            pass
        w.state = "DEAD"
        if w.conn_key is not None:
            self._conn_worker.pop(w.conn_key, None)
        if w.proc is not None:
            try:
                w.proc.kill()
            except OSError:
                pass

    def _reap_idle_workers(self) -> None:
        """Kill workers idle beyond CONFIG.idle_worker_killing_time_s,
        keeping a floor of num_cpus default-env workers warm (reference:
        ``WorkerPool::TryKillingIdleWorkers``)."""
        timeout = CONFIG.idle_worker_killing_time_s
        if timeout <= 0:
            return
        floor = int(self.resources_total.get("CPU", 0))
        now = time.monotonic()
        n_default = sum(
            1 for wid in self._idle
            if (w := self._workers.get(wid)) is not None
            and w.state == "IDLE" and w.env_key == "")
        for wid in list(self._idle):
            w = self._workers.get(wid)
            if (w is None or w.state != "IDLE"
                    or now - w.idle_since < timeout):
                continue
            if w.env_key == "":
                # the warm floor applies to default-env workers only
                if n_default <= floor:
                    continue
                n_default -= 1
            self._kill_worker(wid)

    def _mark_idle(self, w: _Worker) -> None:
        w.state = "IDLE"
        w.task = None
        w.idle_since = time.monotonic()
        self._idle.append(w.worker_id)

    def _worker_log_tail(self, w: _Worker, nbytes: int = 2048) -> str:
        if not w.log_path:
            return "<no log>"
        try:
            with open(w.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - nbytes))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return "<log unreadable>"

    def _reap_startup_failures(self) -> None:
        """Workers that died before registering never produce a conn_closed
        event; reap them here so startup slots aren't leaked forever, and
        count consecutive per-env failures so tasks can fail fast."""
        now = time.monotonic()
        for wid, w in list(self._workers.items()):
            if w.state != "STARTING" or w.proc is None:
                continue
            timeout = (w.register_timeout_s
                       or CONFIG.worker_register_timeout_s)
            if (w.proc.poll() is not None
                    or now - w.started_at > timeout):
                died = w.proc.poll() is not None
                if not died:
                    try:
                        w.proc.kill()
                    except OSError:
                        pass
                del self._workers[wid]
                self._num_starting = max(0, self._num_starting - 1)
                if died or w.env_setup:
                    self.events.error(
                        "WORKER_START_FAILURE",
                        "worker died before registering" if died else
                        "runtime env setup timed out",
                        env_key=w.env_key,
                        pid=w.proc.pid if w.proc else None)
                    # Processes that exited on their own count toward the
                    # env failure budget — a slow registration (killed at
                    # the timeout) is load, not a broken env, and must
                    # not blacklist the default pool. EXCEPT during an
                    # env build: hitting the (much larger) setup deadline
                    # means the build hung; retrying would wipe and
                    # rebuild the venv from zero forever.
                    self._env_spawn_failures[w.env_key] = (
                        self._env_spawn_failures.get(w.env_key, 0) + 1)
                    self._env_spawn_error[w.env_key] = (
                        self._worker_log_tail(w) if died else
                        f"runtime env setup did not finish within "
                        f"{timeout:.0f}s:\n" + self._worker_log_tail(w))

    def _spawn_worker(self, env_key: str = "",
                      worker_runtime_env: Optional[dict] = None,
                      gpus: Optional[List[int]] = None) -> WorkerID:
        from . import runtime_env as renv
        wid = WorkerID.from_random()
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"worker-{wid.hex()[:12]}.log")
        out = open(log_path, "ab")
        env = dict(os.environ)
        env["RTPU_WORKER"] = "1"
        # stdout lands in the worker log file; unbuffered so the log
        # tailer streams prints to the driver as they happen
        env["PYTHONUNBUFFERED"] = "1"
        # Workers see no card at spawn. One spawned for GPU slots (`gpus`,
        # part of its pool key) sets CUDA_VISIBLE_DEVICES to them before
        # each task body runs (worker.py), mapping slot i to the node's
        # i-th visible device; torch reads the variable once, at CUDA's
        # first use, so the pool never hands the worker other slots.
        env["RTPU_NODE_CUDA_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "")
        env["CUDA_VISIBLE_DEVICES"] = ""
        if CONFIG.tracing_enabled:
            # workers read config from env; the driver's _system_config
            # reload doesn't reach their processes
            env["RTPU_TRACING_ENABLED"] = "1"
        cwd = os.getcwd()
        if worker_runtime_env:
            overrides, env_cwd = renv.stage(worker_runtime_env,
                                            self.session_dir)
            env.update(overrides)
            if env_cwd:
                cwd = env_cwd
        # The framework may be importable only via the driver's cwd (not
        # installed); a runtime_env working_dir changes the worker's cwd,
        # so make ray_tpu importable explicitly. Appended last: staged
        # user code shadows it.
        fw_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        pp = env.get("PYTHONPATH", "")
        have = set(pp.split(os.pathsep))
        # Workers resolve by-reference pickles (plain functions/classes
        # passed as args) against the USER-LEVEL import paths of this
        # node's process — locally the driver's script dir, so a
        # function from the user's script module imports inside the
        # worker (reference: same-node workers share the job's
        # environment). Site-packages/stdlib dirs are excluded (they'd
        # shadow a pip runtime-env venv's pinned packages), and a staged
        # working_dir opts out entirely — its snapshot must stay
        # hermetic, not fall through to live driver directories.
        extra = []
        if not (worker_runtime_env
                and "working_dir" in worker_runtime_env):
            extra = [p for p in _user_sys_paths() if p not in have]
        from .config import fw_importable_without_path
        if (not fw_importable_without_path() and fw_root not in have
                and fw_root not in extra):
            extra.append(fw_root)
        if extra:
            env["PYTHONPATH"] = ((pp + os.pathsep if pp else "")
                                 + os.pathsep.join(extra))
        # pip envs go through the bootstrap, which builds/reuses a cached
        # venv in the worker process (never blocking this dispatcher) and
        # execs the real worker under the venv interpreter
        worker_mod = "ray_tpu_torch._private.worker"
        pip = renv.pip_spec(worker_runtime_env)
        if pip is not None:
            worker_mod = "ray_tpu_torch._private.worker_bootstrap"
            env["RTPU_PIP_SPEC"] = json.dumps(pip)
            env["RTPU_ENV_CACHE_DIR"] = os.path.join(
                self.session_dir, "runtime_envs")
            register_timeout = (CONFIG.worker_register_timeout_s
                                + CONFIG.runtime_env_setup_timeout_s)
        else:
            register_timeout = 0.0
        proc = subprocess.Popen(
            [sys.executable, "-m", worker_mod,
             self.socket_path, self.node_id.hex(), wid.hex()],
            stdout=out, stderr=subprocess.STDOUT, env=env,
            cwd=cwd)
        out.close()
        self._workers[wid] = _Worker(worker_id=wid, proc=proc,
                                     env_key=env_key, log_path=log_path,
                                     register_timeout_s=register_timeout,
                                     env_setup=pip is not None)
        self._num_starting += 1
        return wid

    # concurrency: dispatcher-only
    def _assign(self, rec: _TaskRecord, wid: WorkerID) -> None:
        telemetry.counter_inc(telemetry.M_TASKS_DISPATCHED, 1.0, self._mtags)
        telemetry.hist_observe(telemetry.M_QUEUE_WAIT,
                               time.monotonic() - rec.queued_at, self._mtags)
        w = self._workers[wid]
        w.state = "ACTOR" if rec.kind == "actor_create" else "BUSY"
        w.task = rec
        w.assigned_at = time.monotonic()
        rec.worker_id = wid
        if rec.kind == "actor_create":
            w.actor_id = rec.actor_spec.actor_id
            st = self._actors.get(rec.actor_spec.actor_id)
            if st is not None:
                st["worker_id"] = wid
        self._running[rec.spec.task_id] = rec
        self._record_event(rec.spec, "RUNNING")
        self._pin_deps(rec)
        rec.spec.accel_ids = rec.accel_ids
        w.lease_seq += 1
        rec.lease_seq = w.lease_seq
        _pdbg(f"assign {rec.spec.task_id.hex()[:8]} ({rec.kind}) -> "
              f"{w.worker_id.hex()[:6]} seq={rec.lease_seq}")
        self._send_execute(w, (rec.kind, rec.spec, rec.deps,
                               rec.actor_spec, rec.lease_seq))

    # ------------------------------------------------------------ completion
    # concurrency: dispatcher-only
    def _task_done(self, conn_key: int, task_id, metas: List[ObjectMeta],
                   error: Optional[bytes], kind: str,
                   gen_count: Optional[int] = None) -> None:
        rec = self._running.pop(task_id, None)
        _pdbg(f"done {task_id.hex()[:8]} known={rec is not None} "
              f"metas={len(metas)} err={error is not None}")
        if rec is not None:
            self._unpin_deps(rec)
        if gen_count is not None:
            # streaming task finished: record the stream end (count +
            # terminal error) so consumers at any index past the end get
            # StopIteration/the error instead of waiting forever
            lg = self._gen_local.setdefault(
                task_id, {"produced": 0, "done": False, "count": None,
                          "error": None})
            lg.update(done=True, count=gen_count, error=error,
                      produced=max(lg["produced"], gen_count))
            self.gcs.gen_done(task_id, gen_count, error)
            self._gen_consumed_cache.pop(task_id, None)
        for meta in metas:
            self._seal_object(meta)
        if rec is None:
            return
        self._record_event(rec.spec, "FINISHED" if error is None else "FAILED")
        telemetry.counter_inc(
            telemetry.M_TASKS_FINISHED, 1.0,
            self._mtags + (("status", "ok" if error is None else "error"),))
        owned = self._owned.pop(task_id, None)
        if owned is not None:
            # we are the owner: settle inline on the dispatcher instead
            # of a pubsub fan-out + one more queued event per completion
            # (the only subscriber work is this owned-pop + arg unpin)
            try:
                self.gcs.unpin_task_args(task_id)
            except Exception:
                pass
        else:
            # remote owner: its node's subscriber settles it
            self.gcs.publish("TASK_FINISHED", {"task_id": task_id,
                                               "ok": error is None})
        w = self._workers.get(rec.worker_id) if rec.worker_id else None
        if rec.kind == "actor_create":
            self._actor_creation_done(rec, error)
            if not self._in_batch:      # a burst dispatches once, at end
                self._dispatch()
            return
        if rec.kind == "task" and w is not None and w.pipeline:
            # leased pipeline: hand the charge to the next task of the
            # identical shape — the pool totals don't move
            nxt = w.pipeline.popleft()
            _pdbg(f"handoff {w.worker_id.hex()[:6]}: "
                  f"{rec.spec.task_id.hex()[:8]} -> "
                  f"{nxt.spec.task_id.hex()[:8]}")
            telemetry.counter_inc(telemetry.M_LEASE_REUSED, 1.0, self._mtags)
            nxt.charge, rec.charge = rec.charge, None
            w.task = nxt
            w.assigned_at = time.monotonic()
        else:
            self._release_charge(rec)
            if w is not None and w.state == "BUSY":
                self._mark_idle(w)
        if rec.kind == "actor_call" and w is not None:
            w.task = None
        if not self._in_batch:          # a burst dispatches once, at end
            self._dispatch()

    def _seal_object(self, meta: ObjectMeta) -> None:
        self.store.adopt(meta)
        telemetry.counter_inc(telemetry.M_STORE_PUTS, 1.0, self._mtags)
        telemetry.counter_inc(telemetry.M_STORE_PUT_BYTES,
                              float(meta.size), self._mtags)
        self.gcs.publish_location(meta.object_id, self.node_id, meta)
        self.gcs.publish("OBJECT", (meta.object_id, meta))

    # ------------------------------------------------- streaming returns
    def _gen_item(self, task_id, index: int, meta: ObjectMeta) -> None:
        """A streaming task produced item ``index`` (reference:
        ReportGeneratorItemReturns — a worker<->owner report). The item
        is an ordinary object once sealed; the stream counters live in
        a NODE-LOCAL record, and reach the head only for streams whose
        owner sits elsewhere (a traveled ref) — per-item control
        traffic stays off the head on the owner-local hot path
        ."""
        self._seal_object(meta)
        lg = self._gen_local.setdefault(
            task_id, {"produced": 0, "done": False, "count": None,
                      "error": None})
        lg["produced"] = max(lg["produced"], index + 1)
        if task_id not in self._owned:
            # owner is remote: its node's parked waiters unblock off
            # the head's GEN pubsub
            self.gcs.gen_update(task_id, index + 1)
        consumed = self._gen_consumed_cache.get(task_id)
        if consumed:
            # credit that arrived before the task started here
            self._relay_gen_ack(task_id, consumed)
        self._resolve_gen_waiters(task_id, index, meta)

    def _relay_gen_ack(self, task_id, consumed: int) -> None:
        rec = self._running.get(task_id)
        if rec is not None and rec.worker_id is not None:
            w = self._workers.get(rec.worker_id)
            if w is not None and w.conn is not None:
                try:
                    w.conn.send((P.GEN_ACK, (task_id, consumed)))
                except OSError:
                    pass

    def _resolve_gen_waiters(self, task_id, index: int,
                             meta: ObjectMeta) -> None:
        for conn_key, req_id in self._gen_waiters.pop((task_id, index), ()):
            self._reply(conn_key, P.INFO_REPLY, (req_id, ("item", meta)))
            self._gen_consume(task_id, index + 1)

    def _gen_next(self, conn_key: int, req_id: int, task_id,
                  index: int) -> None:
        oid = ObjectID.for_gen_item(task_id, index)
        meta = self._lookup_object(oid)
        if meta is not None:
            self._reply(conn_key, P.INFO_REPLY, (req_id, ("item", meta)))
            self._gen_consume(task_id, index + 1)
            return
        # producer ran here: end-of-stream answers come from the local
        # record, no head read
        st = self._gen_local.get(task_id)
        if st is None:
            st = self.gcs.gen_get(task_id)
        if st is not None and st["done"] and index >= (st["count"] or 0):
            if st["error"] is not None:
                self._reply(conn_key, P.INFO_REPLY,
                            (req_id, ("error", st["error"])))
            else:
                self._reply(conn_key, P.INFO_REPLY,
                            (req_id, ("end", st["count"])))
            return
        self._gen_waiters.setdefault((task_id, index), []).append(
            (conn_key, req_id))

    def _resolve_gen_end_waiters(self, task_id) -> None:
        """Answer parked waiters whose index is at/after the now-known
        end of a stream that terminated here (death/error path)."""
        lg = self._gen_local.get(task_id)
        if lg is None or not lg["done"]:
            return
        count = lg["count"] or 0
        for (tid, index) in [k for k in self._gen_waiters
                             if k[0] == task_id and k[1] >= count]:
            for conn_key, req_id in self._gen_waiters.pop((tid, index)):
                if lg["error"] is not None:
                    self._reply(conn_key, P.INFO_REPLY,
                                (req_id, ("error", lg["error"])))
                else:
                    self._reply(conn_key, P.INFO_REPLY,
                                (req_id, ("end", count)))

    def _gen_consume(self, task_id, consumed: int) -> None:
        """Advance the consumer credit. Producer running HERE: relay the
        GEN_ACK straight to its worker — no head write, no pubsub round
        (the reference's credit flow is likewise worker<->owner). Remote
        producer: the head's GEN channel carries it over."""
        if task_id in self._running:
            if consumed > self._gen_consumed_cache.get(task_id, 0):
                self._gen_consumed_cache[task_id] = consumed
                self._relay_gen_ack(task_id, consumed)
            return
        lg = self._gen_local.get(task_id)
        if lg is not None and lg["done"]:
            return      # producer finished here: credit has no reader
        self.gcs.gen_consumed(task_id, consumed)

    def _gen_close(self, task_id) -> None:
        """Consumer finished with / dropped its generator: unblock the
        producer forever (credit -> infinity), drop parked waiters, and
        drop the control-plane stream record (a late gen_update from a
        still-running producer recreates it harmlessly — the worker's
        credit is already infinite)."""
        self._gen_consume(task_id, 1 << 62)
        for key in [k for k in self._gen_waiters if k[0] == task_id]:
            del self._gen_waiters[key]
        self._gen_local.pop(task_id, None)
        self.gcs.gen_drop(task_id)

    def _on_gen_published(self, payload) -> None:
        self._events.put(("gen_event", payload))

    def _on_gen_event(self, payload) -> None:
        task_id, kind, n = payload
        if kind == "consumed":
            # relay credit to the producer if it runs on this node; also
            # cache it — if the task hasn't STARTED here yet, the relay
            # happens on its first GEN_ITEM instead
            if n > self._gen_consumed_cache.get(task_id, 0):
                self._gen_consumed_cache[task_id] = n
            self._relay_gen_ack(task_id, n)
        elif kind == "done":
            # stream ended: answer parked waiters at/past the end (the
            # producing node answers from its local record — the head
            # read is only for streams that ran elsewhere)
            st = self._gen_local.get(task_id)
            if st is None:
                st = self.gcs.gen_get(task_id)
            if st is None:
                return
            for (tid, index) in [k for k in self._gen_waiters
                                 if k[0] == task_id and k[1] >= n]:
                for conn_key, req_id in self._gen_waiters.pop((tid, index)):
                    if st["error"] is not None:
                        self._reply(conn_key, P.INFO_REPLY,
                                    (req_id, ("error", st["error"])))
                    else:
                        self._reply(conn_key, P.INFO_REPLY,
                                    (req_id, ("end", n)))
        elif kind == "produced":
            # an item produced on ANOTHER node: its OBJECT publish may
            # have raced ahead of our waiter registration — re-check
            index = n - 1
            waiters = self._gen_waiters.get((task_id, index))
            if waiters:
                oid = ObjectID.for_gen_item(task_id, index)
                meta = self._lookup_object(oid)
                if meta is not None:
                    del self._gen_waiters[(task_id, index)]
                    for conn_key, req_id in waiters:
                        self._reply(conn_key, P.INFO_REPLY,
                                    (req_id, ("item", meta)))
                        self._gen_consume(task_id, index + 1)

    def _on_object_published(self, payload) -> None:
        oid, meta = payload
        self._events.put(("object_ready", oid, meta))

    def _on_object_ready(self, oid: ObjectID, meta: ObjectMeta) -> None:
        self._reconstructing.discard(oid)
        # resolve task dependencies
        for tid in self._dep_index.pop(oid, ()):  # noqa: B020
            rec = self._waiting_deps.get(tid)
            if rec is None:
                continue
            rec.deps[oid] = meta
            rec.remaining_deps.discard(oid)
            if not rec.remaining_deps:
                del self._waiting_deps[tid]
                if rec.kind == "actor_call_waiting":
                    rec.kind = "actor_call"
                    self._send_actor_call(rec)
                    self._unblock_actor_owner(rec.spec)
                else:
                    # pending-queue starvation is measured from HERE, not
                    # record creation — dep-wait time must not trigger an
                    # immediate locality-losing spillback
                    rec.queued_at = time.monotonic()
                    self._pending.append(rec)
        # resolve client waiters
        for waiter_id in list(self._obj_waiter_index.pop(oid, ())):
            waiter = (self._get_waiters.get(waiter_id)
                      or self._wait_waiters.get(waiter_id))
            if waiter is None:
                continue
            waiter.remaining.discard(oid)
            self._maybe_fire_waiter(waiter_id, waiter)
        if not self._in_batch:
            self._dispatch()

    def _fail_returns(self, spec: P.TaskSpec, exc: Exception) -> None:
        err = to_bytes(exc)
        for oid in spec.return_ids:
            meta = ObjectMeta(object_id=oid, size=len(err), error=err)
            self._seal_object(meta)
        if spec.num_returns == -1:
            # streaming task died mid-production: end the stream with the
            # error at the next unproduced index so consumers don't hang
            # — in BOTH the node-local record (owner-local consumers
            # probe it first) and the head's
            lg = self._gen_local.get(spec.task_id)
            produced = (lg or {}).get("produced")
            if produced is None:
                st = self.gcs.gen_get(spec.task_id)
                produced = (st or {}).get("produced", 0)
            if lg is not None:
                lg.update(done=True, count=produced, error=err)
            else:
                self._gen_local[spec.task_id] = {
                    "produced": produced, "done": True,
                    "count": produced, "error": err}
            self.gcs.gen_done(spec.task_id, produced, err)
            self._resolve_gen_end_waiters(spec.task_id)
        self.gcs.publish("TASK_FINISHED", {"task_id": spec.task_id,
                                           "ok": False})

    # ---------------------------------------------------------------- actors
    def _create_actor(self, spec: P.ActorSpec) -> None:
        try:
            self.gcs.register_actor(spec)
        except ValueError as e:
            # duplicate named actor: surface the error through the
            # creation ref instead of a half-registered phantom record
            if spec.creation_return_id:
                err = to_bytes(e)
                self._seal_object(ObjectMeta(
                    object_id=spec.creation_return_id, size=len(err),
                    error=err))
            return
        self._owned[ActorTaskIds.creation_task(spec)] = _OwnedTask(
            spec=self._creation_task_spec(spec), kind="actor_create",
            retries_left=0, actor_spec=spec)
        self._pin_submission(ActorTaskIds.creation_task(spec),
                             self._arg_refs(spec))
        self._route_actor(spec)

    def _probe_target(self, spec) -> Optional[NodeID]:
        """Where this spec would schedule right now (None = infeasible)."""
        strategy = spec.scheduling_strategy
        if isinstance(strategy, sched.PlacementGroupSchedulingStrategy):
            return self._pg_target_node(strategy)
        demand = (self._creation_demand(spec)
                  if isinstance(spec, P.ActorSpec) else spec.resources)
        return sched.pick_node(demand, strategy or sched.DEFAULT,
                               self._candidates(), self.node_id, self._rng)

    def _route_actor(self, spec: P.ActorSpec) -> None:
        target = self._probe_target(spec)
        if target is None:
            if not self._park_infeasible("actor", spec):
                self._fail_actor_infeasible(spec)
            return
        self.gcs.set_actor_state(spec.actor_id, ACTOR_PENDING, node_id=target)
        if target == self.node_id:
            self._local_create_actor(spec)
        else:
            peer = self._peer(target)
            if peer is None:
                self.gcs.set_actor_state(spec.actor_id, ACTOR_DEAD,
                                         reason="target node died")
                if spec.creation_return_id:
                    err = to_bytes(exceptions.ActorDiedError(
                        spec.actor_id, "target node died before creation"))
                    self._seal_object(ObjectMeta(
                        object_id=spec.creation_return_id, size=len(err),
                        error=err))
                return
            self._debit_route(target, spec.resources)
            peer.post_remote(("remote_actor_create", spec))

    def _fail_queued_actor_tasks(self, actor_id: ActorID,
                                 reason: str) -> None:
        """Fail every method call still queued for a dead actor."""
        q = self._actor_queues.get(actor_id)
        while q:
            qspec = q.popleft()
            self._fail_returns(qspec, exceptions.ActorDiedError(
                actor_id, reason))
        self._actor_blocked_owners.pop(actor_id, None)

    def _creation_task_spec(self, spec: P.ActorSpec) -> P.TaskSpec:
        return P.TaskSpec(
            task_id=ActorTaskIds.creation_task(spec),
            job_id=spec.job_id,
            name=f"{spec.name}.__init__",
            function_id=b"",
            args=spec.args, kwargs=spec.kwargs,
            num_returns=1,
            return_ids=[spec.creation_return_id] if spec.creation_return_id else [],
            resources=self._creation_demand(spec),
            scheduling_strategy=spec.scheduling_strategy)

    @staticmethod
    def _creation_demand(spec: P.ActorSpec) -> Dict[str, float]:
        """Resource demand of the actor CREATION task. Reference
        semantics (``actor.py:384``): an actor with no explicit
        resources charges 1 CPU while its __init__ runs — gating
        concurrent creations — and 0 afterwards (the charge is released
        in ``_actor_creation_done``). An EXPLICIT num_cpus=0 arrives as
        resources {"CPU": 0.0} and skips the implicit charge (0 for
        creation AND running) — a 0-CPU helper actor must be creatable
        on a saturated node or the busy actors waiting on it deadlock.
        PG-scheduled actors draw from their bundle, where an implicit
        CPU may not exist."""
        if spec.resources:
            return spec.resources
        if isinstance(spec.scheduling_strategy,
                      sched.PlacementGroupSchedulingStrategy):
            return {}
        return {"CPU": 1.0}

    def _local_create_actor(self, spec: P.ActorSpec) -> None:
        self._actors[spec.actor_id] = {
            "spec": spec, "worker_id": None, "state": ACTOR_PENDING,
            "restarts_left": spec.max_restarts, "no_restart": False,
        }
        self._actor_queues.setdefault(spec.actor_id, deque())
        tspec = self._creation_task_spec(spec)
        self._queue_local(tspec, "actor_create", actor_spec=spec)

    def _actor_creation_done(self, rec: _TaskRecord,
                             error: Optional[bytes]) -> None:
        spec = rec.actor_spec
        st = self._actors.get(spec.actor_id)
        if error is not None:
            if st:
                st["state"] = ACTOR_DEAD
            self._release_charge(rec)
            self.gcs.set_actor_state(spec.actor_id, ACTOR_DEAD,
                                     reason="creation task failed")
            # method calls queued while the actor was PENDING would hang
            # forever otherwise
            self._fail_queued_actor_tasks(spec.actor_id,
                                          "actor creation failed")
            w = self._workers.get(rec.worker_id)
            if w is not None:
                w.actor_id = None
                self._mark_idle(w)
            return
        # actor keeps its resource charge (and GPU slots) for its
        # lifetime — except the implicit creation-only 1 CPU (see
        # _creation_demand), which is returned now that __init__ is done
        if st is not None:
            st["state"] = ACTOR_ALIVE
            st["worker_id"] = rec.worker_id
            st["pg_key"] = rec.pg_key
            if spec.resources:
                st["charge"] = rec.charge
                st["accel_ids"] = rec.accel_ids
                rec.accel_ids = None   # ownership moved: rec release
                rec.charge = None      # must not double-return them
            else:
                self._release_charge(rec)
                st["charge"] = None
                st["accel_ids"] = None
        w = self._workers.get(rec.worker_id)
        if w is not None:
            w.task = None
        self.gcs.set_actor_state(spec.actor_id, ACTOR_ALIVE,
                                 node_id=self.node_id)
        self._flush_actor_queue(spec.actor_id)

    def _submit_actor_task(self, spec: P.TaskSpec) -> None:
        telemetry.counter_inc(telemetry.M_TASKS_SUBMITTED, 1.0, self._mtags)
        self._owned[spec.task_id] = _OwnedTask(
            spec=spec, kind="actor_call", retries_left=spec.max_retries)
        self._pin_submission(spec.task_id, self._arg_refs(spec))
        rec = self.gcs.get_actor(spec.actor_id)
        if rec is None or rec.state == ACTOR_DEAD:
            self._fail_returns(spec, exceptions.ActorDiedError(
                spec.actor_id, rec.death_reason if rec else "unknown actor"))
            return
        if rec.state == ACTOR_RESTARTING and rec.node_id is None:
            # reroute window after a node death: no host exists yet.
            # Park until placement (or death) — failing now would turn a
            # survivable restart into a terminal ActorDiedError
            self._reroute_parked.setdefault(
                spec.actor_id, []).append(spec)
            return
        owned = self._owned[spec.task_id]
        owned.assigned_node = rec.node_id
        if rec.node_id is not None:
            self._record_task_origin(spec.task_id, rec.node_id)
        if rec.node_id == self.node_id or rec.node_id is None:
            self._local_actor_task(spec)
        else:
            peer = self._peer(rec.node_id)
            if peer is None:
                self._fail_returns(spec, exceptions.ActorDiedError(
                    spec.actor_id, "actor node is dead"))
                return
            peer.post_remote(("remote_actor_task", spec))

    def _local_actor_task(self, spec: P.TaskSpec) -> None:
        st = self._actors.get(spec.actor_id)
        if st is None or st["state"] == ACTOR_DEAD:
            reason = st and "actor is dead" or "unknown actor"
            self._fail_returns(spec, exceptions.ActorDiedError(
                spec.actor_id, reason))
            return
        self._actor_queues[spec.actor_id].append(spec)
        if st["state"] == ACTOR_ALIVE:
            self._flush_actor_queue(spec.actor_id)

    def _flush_actor_queue(self, actor_id: ActorID) -> None:
        st = self._actors.get(actor_id)
        q = self._actor_queues.get(actor_id)
        if st is None or q is None or st["state"] != ACTOR_ALIVE:
            return
        w = self._workers.get(st["worker_id"])
        if w is None or w.conn is None:
            return
        blocked = self._actor_blocked_owners.setdefault(actor_id, set())
        held = []            # calls parked behind a same-owner dep wait
        while q:
            spec = q.popleft()
            if spec.owner_id in blocked:
                # an earlier call from this submitter is dep-waiting: a
                # stateful actor must not observe call N+1 before call N
                held.append(spec)
                continue
            rec = _TaskRecord(spec=spec, kind="actor_call", worker_id=w.worker_id)
            # resolve deps inline; actor calls with unresolved deps wait
            unresolved = False
            for slot, val in list(spec.args) + list(spec.kwargs.values()):
                if slot == "r":
                    meta = self._lookup_object(val)
                    if meta is None:
                        unresolved = True
                        self._add_dep(rec, val)
                    else:
                        rec.deps[val] = meta
            if unresolved:
                self._waiting_deps[spec.task_id] = rec
                rec.kind = "actor_call_waiting"
                blocked.add(spec.owner_id)
                continue
            self._send_actor_call(rec)
        if held:
            q.extendleft(reversed(held))

    def _unblock_actor_owner(self, spec: P.TaskSpec) -> None:
        """A dep-waiting call from this submitter left the wait state
        (sent, failed, or cancelled): release the calls held behind it."""
        blocked = self._actor_blocked_owners.get(spec.actor_id)
        if blocked is not None and spec.owner_id in blocked:
            blocked.discard(spec.owner_id)
            self._flush_actor_queue(spec.actor_id)

    def _send_actor_call(self, rec: _TaskRecord) -> None:
        st = self._actors.get(rec.spec.actor_id)
        if st is None or st["state"] == ACTOR_DEAD:
            self._fail_returns(rec.spec, exceptions.ActorDiedError(
                rec.spec.actor_id, "actor is dead"))
            return
        if st["state"] != ACTOR_ALIVE:
            # head of the queue, not tail: this call is older than any
            # same-owner call already queued (it blocked them while
            # dep-waiting), and per-owner order must survive a restart
            self._actor_queues[rec.spec.actor_id].appendleft(rec.spec)
            return
        w = self._workers.get(st["worker_id"])
        if w is None or w.conn is None:
            self._actor_queues[rec.spec.actor_id].appendleft(rec.spec)
            return
        self._running[rec.spec.task_id] = rec
        self._record_event(rec.spec, "RUNNING")
        self._pin_deps(rec)
        rec.spec.accel_ids = st.get("accel_ids")
        # seq 0: actor calls are never leased/returned, but the EXECUTE
        # tuple shape is uniform
        self._send_execute(w, ("actor_call", rec.spec, rec.deps, None, 0))

    def _kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        rec = self.gcs.get_actor(actor_id)
        if rec is None:
            return
        if rec.node_id == self.node_id or rec.node_id is None:
            self._local_kill_actor(actor_id, no_restart)
        else:
            peer = self._peer(rec.node_id)
            if peer is not None:
                peer.post_remote(("remote_kill_actor", actor_id, no_restart))

    def _local_kill_actor(self, actor_id: ActorID, no_restart: bool,
                          reason: str = "killed via kill()") -> None:
        st = self._actors.get(actor_id)
        if st is None:
            return
        st["no_restart"] = st["no_restart"] or no_restart
        w = self._workers.get(st.get("worker_id"))
        if w is not None and w.proc is not None:
            try:
                w.proc.kill()
            except OSError:
                pass
        else:
            self._drop_queued_creation(actor_id)
            self._handle_actor_death(actor_id, reason)

    def _drop_queued_creation(self, actor_id: ActorID) -> None:
        """Purge a never-placed actor's creation record: left queued, it
        would bring the killed actor up once its resources free, and hold
        them (a killed pending replica took the card a redeploy needed)."""
        for rec in list(self._pending):
            if (rec.kind == "actor_create" and rec.actor_spec is not None
                    and rec.actor_spec.actor_id == actor_id):
                rec.cancelled = True
                self._pending.remove(rec)
        for tid, rec in list(self._waiting_deps.items()):
            if (rec.kind == "actor_create" and rec.actor_spec is not None
                    and rec.actor_spec.actor_id == actor_id):
                del self._waiting_deps[tid]

    def _handle_actor_death(self, actor_id: ActorID, reason: str) -> None:
        st = self._actors.get(actor_id)
        if st is None:
            return
        can_restart = (st["restarts_left"] != 0) and not st["no_restart"]
        self.events.emit(
            "WARNING" if can_restart else "ERROR", "ACTOR_DEATH", reason,
            actor_id=actor_id.hex(), will_restart=can_restart)
        # fail tasks currently running on the actor
        for tid, rec in list(self._running.items()):
            if rec.spec.actor_id == actor_id:
                del self._running[tid]
                self._unpin_deps(rec)
                self._fail_returns(rec.spec, exceptions.ActorDiedError(
                    actor_id, reason))
        self._release_actor_charge(st)
        if can_restart:
            if st["restarts_left"] > 0:
                st["restarts_left"] -= 1
            st["state"] = ACTOR_RESTARTING
            self.gcs.set_actor_state(actor_id, ACTOR_RESTARTING,
                                     node_id=self.node_id,
                                     count_restart=True)
            spec = st["spec"]
            tspec = self._creation_task_spec(spec)
            # The creation ref is single-use: keep it only if the first
            # creation never sealed it (worker died mid-__init__), so a
            # waiter on the ready-ref unblocks when the restart completes.
            if (spec.creation_return_id
                    and self._object_exists(spec.creation_return_id)):
                tspec.return_ids = []
            self._queue_local(tspec, "actor_create", actor_spec=spec)
        else:
            st["state"] = ACTOR_DEAD
            self.gcs.set_actor_state(actor_id, ACTOR_DEAD, reason=reason)
            # Seal the creation ref with the death error if it was never
            # sealed — otherwise a driver waiting on the ready-ref hangs
            # forever. (A ref already sealed by a successful __init__ must
            # not be overwritten in the directory.)
            spec = st["spec"]
            if (spec.creation_return_id
                    and not self._object_exists(spec.creation_return_id)):
                self._fail_returns(self._creation_task_spec(spec),
                                   exceptions.ActorDiedError(actor_id, reason))
            self._fail_queued_actor_tasks(actor_id, reason)

    def _release_actor_charge(self, st: dict) -> None:
        """Return a live actor's resource charge to the pool it came from —
        the node's free set or its placement-group bundle reservation."""
        charge = st.get("charge")
        if not charge:
            return
        st["charge"] = None
        with self._res_lock:
            pg_key = st.get("pg_key")
            if pg_key is not None:
                pool = self.pg_reservations.get(pg_key)
                if pool is not None:
                    sched.add(pool, charge)
            else:
                sched.add(self.resources_available, charge)
            st["accel_ids"] = self._return_gpu_slots(st.get("accel_ids"))

    def _on_actor_event(self, payload) -> None:
        if payload.get("state") == ACTOR_DEAD:
            self._events.put(("actor_dead", payload["actor_id"],
                              payload.get("reason", "")))
        elif payload.get("reroute"):
            self._events.put(("actor_reroute", payload["actor_id"]))
        if payload["actor_id"] in self._reroute_parked:
            # placement progressed (or death became final): re-drive the
            # calls parked during the reroute window
            self._events.put(("actor_parked_flush", payload["actor_id"]))

    def _flush_parked_actor_calls(self, actor_id: ActorID) -> None:
        for spec in self._reroute_parked.pop(actor_id, []):
            # re-enters the normal path: re-parks if still unplaced,
            # fails with the real death reason if the restart lost
            self._submit_actor_task(spec)

    def _reroute_actor(self, actor_id: ActorID) -> None:
        """Re-create a restartable actor whose node died. All nodes see
        the reroute event; the GCS claim admits exactly one."""
        try:
            orig_spec = self.gcs.claim_actor_reroute(actor_id)
        except Exception:   # noqa: BLE001 — plane unreachable: give up
            return
        if orig_spec is None:
            return
        try:
            import copy
            spec = copy.copy(orig_spec)
            rec = self.gcs.get_actor(actor_id)
            if spec.max_restarts >= 0 and rec is not None:
                # the new host's restart budget excludes restarts already
                # consumed (worker deaths and node deaths both count)
                spec.max_restarts = max(0, spec.max_restarts
                                        - rec.num_restarts)
            if (spec.creation_return_id
                    and self._object_exists(spec.creation_return_id)):
                # ready-ref already sealed by the first creation: the
                # re-creation must not seal it again
                spec.creation_return_id = None
            self.events.warning(
                "ACTOR_REROUTE", "restarting actor from a dead node",
                actor_id=actor_id.hex())
            self._route_actor(spec)
        except BaseException:
            # the claim is exactly-once: losing the spec here would
            # strand the actor in RESTARTING forever — hand it back so
            # another (or a later) claimant can retry
            try:
                self.gcs.requeue_actor_reroute(actor_id, orig_spec)
            except Exception:   # noqa: BLE001 — plane gone too
                pass
            raise

    def _on_remote_actor_dead(self, actor_id: ActorID, reason: str) -> None:
        """Owner-side: fail owned in-flight calls to an actor that died on
        another node (our local running set doesn't cover those)."""
        for tid, owned in list(self._owned.items()):
            if (owned.kind == "actor_call" and not owned.done
                    and owned.spec.actor_id == actor_id
                    and owned.assigned_node != self.node_id):
                owned.done = True
                self._fail_returns(owned.spec,
                                   exceptions.ActorDiedError(actor_id, reason))

    # --------------------------------------------------------- cancellation
    def _cancel_task(self, task_id: TaskID, force: bool) -> None:
        owned = self._owned.get(task_id)
        if owned is None or owned.done:
            return
        target = owned.assigned_node
        if target == self.node_id or target is None:
            self._local_cancel(task_id, force)
        else:
            peer = self._peer(target)
            if peer is not None:
                peer.post_remote(("remote_cancel", task_id, force))

    def _local_cancel(self, task_id: TaskID, force: bool) -> None:
        rec = self._waiting_deps.pop(task_id, None)
        if rec is not None and rec.kind == "actor_call_waiting":
            self._unblock_actor_owner(rec.spec)
        if rec is None:
            for r in self._pending:
                if r.spec.task_id == task_id:
                    rec = r
                    r.cancelled = True
                    # purge immediately: a cancelled rec parked behind a
                    # non-fitting bucket head would otherwise sit in the
                    # queue forever, feeding phantom demand to the
                    # autoscaler via pending_demand()
                    self._pending.remove(r)
                    break
        if rec is not None:
            self._fail_returns(rec.spec, exceptions.TaskCancelledError(task_id))
            return
        rec = self._running.get(task_id)
        if rec is not None and rec.worker_id is not None:
            w = self._workers.get(rec.worker_id)
            if w is not None and rec is not w.task and rec in w.pipeline:
                # leased-but-not-running: a signal would hit the wrong
                # task; tell the worker to skip it when its turn comes
                # and fail the returns here (the skip reply is
                # meta-less)
                rec.cancelled = True
                w.pipeline.remove(rec)
                self._running.pop(task_id, None)
                self._unpin_deps(rec)
                if w.conn is not None:
                    try:
                        w.conn.send((P.CANCEL_QUEUED, task_id))
                    except OSError:
                        pass
                self._fail_returns(rec.spec,
                                   exceptions.TaskCancelledError(task_id))
                return
            if w is not None and w.proc is not None:
                import signal
                try:
                    w.proc.send_signal(
                        signal.SIGKILL if force else signal.SIGINT)
                except OSError:
                    pass

    # ------------------------------------------------------------- get/wait
    def _get_objects(self, conn_key: int, req_id: int,
                     object_ids: List[ObjectID],
                     timeout: Optional[float],
                     fetch: bool = False) -> None:
        waiter = _Waiter(req_id=req_id, conn_key=conn_key,
                         object_ids=object_ids, fetch=fetch)
        for oid in object_ids:
            if not self._object_exists(oid):
                waiter.remaining.add(oid)
                self._maybe_reconstruct(oid)
        n_miss = len(waiter.remaining)
        if n_miss:
            telemetry.counter_inc(telemetry.M_STORE_MISSES,
                                  float(n_miss), self._mtags)
        if len(object_ids) > n_miss:
            telemetry.counter_inc(telemetry.M_STORE_HITS,
                                  float(len(object_ids) - n_miss),
                                  self._mtags)
        if not waiter.remaining:
            self._fire_get(waiter)
            return
        waiter_id = self._next_waiter
        self._next_waiter += 1
        self._get_waiters[waiter_id] = waiter
        for oid in waiter.remaining:
            self._obj_waiter_index.setdefault(oid, set()).add(waiter_id)
        if timeout is not None:
            waiter.timer = threading.Timer(
                timeout, lambda: self._events.put(
                    ("timer", lambda: self._timeout_get(waiter_id))))
            waiter.timer.daemon = True
            waiter.timer.start()

    def _maybe_fire_waiter(self, waiter_id: int, waiter: _Waiter) -> None:
        if waiter_id in self._get_waiters:
            if not waiter.remaining:
                del self._get_waiters[waiter_id]
                if waiter.timer:
                    waiter.timer.cancel()
                self._fire_get(waiter)
        elif waiter_id in self._wait_waiters:
            ready = len(waiter.object_ids) - len(waiter.remaining)
            if ready >= waiter.num_returns:
                del self._wait_waiters[waiter_id]
                if waiter.timer:
                    waiter.timer.cancel()
                self._fire_wait(waiter)

    def _fire_get(self, waiter: _Waiter) -> None:
        metas = [self._lookup_object(oid) for oid in waiter.object_ids]
        served = sum(m.size for m in metas if m is not None)
        if served:
            telemetry.counter_inc(telemetry.M_STORE_GET_BYTES,
                                  float(served), self._mtags)
        if waiter.fetch:
            # Payload copies + frame pickling for a wire driver can be
            # hundreds of MB; do them off the dispatcher (Connection.send
            # is thread-safe), mirroring why puts live in _DIRECT_OPS.
            threading.Thread(
                target=self._fire_get_fetch,
                args=(waiter, metas), daemon=True,
                name="rtpu-wire-fetch").start()
            return
        self._reply_batched(waiter.conn_key, P.GET_REPLY,
                            (waiter.req_id, metas))

    def _fire_get_fetch(self, waiter: _Waiter, metas) -> None:
        wire = [self._wire_meta(oid, meta)
                for oid, meta in zip(waiter.object_ids, metas)]
        self._reply(waiter.conn_key, P.GET_REPLY, (waiter.req_id, wire))

    def _wire_meta(self, oid: ObjectID,
                   meta: Optional[ObjectMeta]) -> Optional[ObjectMeta]:
        """Meta with the payload inlined, for drivers that share no
        /dev/shm with this host (Ray-Client-equivalent data plane).
        ``meta`` comes from ``_lookup_object``, which has already adopted
        cross-host payloads into our store via the peer pull. Never
        raises: a None return makes the client surface ObjectLostError."""
        if meta is None or meta.inline is not None or meta.error is not None:
            return meta
        try:
            res = self.store.read_payload(oid)
            if res is not None:
                meta, data = res
                if data is None:         # store held it inline / as error
                    return meta
            else:
                # same-host sibling store (in-process cluster): attach by
                # segment name / arena path
                data = object_store.read_wire_bytes(meta)
        except Exception:                # noqa: BLE001 — must always reply
            return None
        if data is None:
            return None
        return ObjectMeta(object_id=oid, size=meta.size, inline=data)

    def _drop_waiter_index(self, waiter_id: int, waiter: _Waiter) -> None:
        for oid in waiter.remaining:
            ids = self._obj_waiter_index.get(oid)
            if ids is not None:
                ids.discard(waiter_id)
                if not ids:
                    del self._obj_waiter_index[oid]

    def _timeout_get(self, waiter_id: int) -> None:
        waiter = self._get_waiters.pop(waiter_id, None)
        if waiter is None:
            return
        self._drop_waiter_index(waiter_id, waiter)
        err = to_bytes(exceptions.GetTimeoutError(
            f"objects not ready within timeout: "
            f"{[o.hex()[:12] for o in waiter.remaining]}"))
        self._reply(waiter.conn_key, P.ERROR_REPLY, (waiter.req_id, err))

    def _wait_objects(self, conn_key: int, req_id: int,
                      object_ids: List[ObjectID], num_returns: int,
                      timeout: Optional[float]) -> None:
        waiter = _Waiter(req_id=req_id, conn_key=conn_key,
                         object_ids=object_ids, num_returns=num_returns)
        for oid in object_ids:
            if not self._object_exists(oid):
                waiter.remaining.add(oid)
                self._maybe_reconstruct(oid)
        ready = len(object_ids) - len(waiter.remaining)
        if ready >= num_returns or timeout == 0:
            self._fire_wait(waiter)
            return
        waiter_id = self._next_waiter
        self._next_waiter += 1
        self._wait_waiters[waiter_id] = waiter
        for oid in waiter.remaining:
            self._obj_waiter_index.setdefault(oid, set()).add(waiter_id)
        if timeout is not None:
            waiter.timer = threading.Timer(
                timeout, lambda: self._events.put(
                    ("timer", lambda: self._timeout_wait(waiter_id))))
            waiter.timer.daemon = True
            waiter.timer.start()

    def _fire_wait(self, waiter: _Waiter) -> None:
        ready = [oid for oid in waiter.object_ids
                 if oid not in waiter.remaining]
        pending = [oid for oid in waiter.object_ids if oid in waiter.remaining]
        self._reply_batched(waiter.conn_key, P.WAIT_REPLY,
                            (waiter.req_id, ready, pending))

    def _timeout_wait(self, waiter_id: int) -> None:
        waiter = self._wait_waiters.pop(waiter_id, None)
        if waiter is None:
            return
        self._drop_waiter_index(waiter_id, waiter)
        self._fire_wait(waiter)

    # ------------------------------------------------------- failure paths
    def _on_conn_closed(self, key: int) -> None:
        conn = self._conns.pop(key, None)
        self._driver_conn_keys.discard(key)
        # retire the collective route only if it still points at THIS
        # conn (a restarted process re-registers under the same id)
        cwid = self._conn_coll_wid.pop(key, None)
        if cwid is not None and self._coll_conns.get(cwid) is conn:
            self._coll_conns.pop(cwid, None)
        # arena Creates this connection never sealed are garbage now
        self.store.reclaim_unsealed(key)
        # a dead consumer's parked stream requests: drop the waiters and
        # release the producers it was pacing (synthesized GEN_CLOSE)
        dead_streams = set()
        for (tid, index), waiters in list(self._gen_waiters.items()):
            kept = [(ck, rid) for ck, rid in waiters if ck != key]
            if len(kept) != len(waiters):
                dead_streams.add(tid)
                if kept:
                    self._gen_waiters[(tid, index)] = kept
                else:
                    del self._gen_waiters[(tid, index)]
        for tid in dead_streams:
            self._gen_close(tid)
        # the process died with references: drop them all at once
        held = self._conn_refs.pop(key, None)
        if held:
            try:
                self.gcs.drop_all_refs(self._holder_id(key), list(held))
            except Exception:
                pass
        wid = self._conn_worker.pop(key, None)
        if wid is None:
            return
        w = self._workers.pop(wid, None)
        if w is None:
            return
        if self._stopped.is_set():
            return
        w.state = "DEAD"
        try:
            self._idle.remove(wid)
        except ValueError:
            pass
        if w.actor_id is not None:
            st = self._actors.get(w.actor_id)
            # fail the creation task if it was in flight
            rec = w.task
            if rec is not None and rec.kind == "actor_create":
                self._running.pop(rec.spec.task_id, None)
                self._unpin_deps(rec)
                self._release_charge(rec)
            self._handle_actor_death(
                w.actor_id,
                "actor worker killed by the memory monitor (node out of "
                "memory)" if w.oom_victim else "actor worker process died")
            return
        # the running task AND any leased pipeline behind it died with
        # the process; only the running one holds a charge
        for rec in ([w.task] if w.task is not None else []) \
                + list(w.pipeline):
            self._running.pop(rec.spec.task_id, None)
            self._unpin_deps(rec)
            self._release_charge(rec)
            if w.oom_victim and rec.oom_retries_left > 0:
                # OOM retries are a separate budget: the task did nothing
                # wrong, the node ran out of memory under it
                rec.oom_retries_left -= 1
                rec.worker_id = None
                rec.charge = None
                self._pending.append(rec)
            elif not w.oom_victim and rec.retries_left > 0:
                rec.retries_left -= 1
                rec.worker_id = None
                rec.charge = None
                self._pending.append(rec)
            elif w.oom_victim:
                self._fail_returns(rec.spec, exceptions.OutOfMemoryError(
                    f"task {rec.spec.name} was killed by the memory "
                    f"monitor to relieve node memory pressure "
                    f"(usage >= {CONFIG.memory_usage_threshold:.0%}); "
                    f"oom retries exhausted"))
            else:
                self._fail_returns(rec.spec, exceptions.WorkerCrashedError(
                    f"worker died while running {rec.spec.name}"))
        w.pipeline.clear()
        if not self._in_batch:
            self._dispatch()

    def _on_node_event(self, payload) -> None:
        if payload.get("state") == "DEAD" and payload["node_id"] != self.node_id:
            self._events.put(("node_dead", payload["node_id"]))
        elif payload.get("state") == "ALIVE" and self._infeasible:
            # fresh capacity (autoscaler scale-up): retry parked work
            self._events.put(("timer", self._retry_infeasible))

    def _on_task_finished(self, payload) -> None:
        self._events.put(("task_finished", payload["task_id"]))

    def _on_node_dead(self, node_id: NodeID) -> None:
        """Owner-side recovery: resubmit or fail tasks we forwarded to a node
        that died (reference: lease failure + ``RetryTaskIfPossible``), and
        rebuild lost objects that local waiters/deps still need
        (``object_recovery_manager.h:90``)."""
        # every surviving node observes the same death: only the node
        # co-located with the control plane publishes it cluster-wide
        self.events.warning("NODE_DEATH", "peer node died",
                            dead_node_id=node_id.hex(),
                            local_only=not isinstance(
                                self.gcs, GlobalControlPlane))
        peer = self._peers.pop(node_id, None)
        if peer is not None:
            peer.close()
        for oid in set(self._obj_waiter_index) | set(self._dep_index):
            self._maybe_reconstruct(oid)   # claim gate filters non-lost
        for tid, owned in list(self._owned.items()):
            if owned.done or owned.assigned_node != node_id:
                continue
            if owned.kind == "task":
                if owned.retries_left > 0:
                    owned.retries_left -= 1
                    self._route_task(owned.spec)
                else:
                    self._fail_returns(owned.spec,
                                       exceptions.WorkerCrashedError(
                                           f"node {node_id} died"))
                    owned.done = True
            elif owned.kind == "actor_call":
                self._fail_returns(owned.spec, exceptions.ActorDiedError(
                    owned.spec.actor_id, f"node {node_id} died"))
                owned.done = True

    # -------------------------------------------------------------- pg/info
    def _create_pg(self, conn_key: int, payload) -> None:
        req_id, spec = payload
        assignment = sched.pack_bundles(spec.bundles, spec.strategy,
                                        self._candidates())
        if assignment is None:
            # make the gang demand visible to the autoscaler; refreshed
            # on every client retry, cleared on success/removal
            self.gcs.register_pending_pg(spec)
            self._reply(conn_key, P.INFO_REPLY, (req_id, None))
            return
        ok = True
        reserved = []
        for idx, (bundle, nid) in enumerate(zip(spec.bundles, assignment)):
            peer = self._peer(nid)
            if peer is None or not peer.reserve_bundle((spec.pg_id, idx),
                                                       bundle):
                ok = False
                break
            reserved.append((peer, (spec.pg_id, idx)))
        if not ok:
            for peer, key in reserved:
                peer.release_bundle(key)
            self._reply(conn_key, P.INFO_REPLY, (req_id, None))
            return
        self.gcs.register_pg(spec, assignment)
        self.gcs.clear_pending_pg(spec.pg_id)
        self._reply(conn_key, P.INFO_REPLY, (req_id, assignment))

    def _remove_pg(self, pg_id) -> None:
        self.gcs.clear_pending_pg(pg_id)
        rec = self.gcs.remove_pg(pg_id)
        if rec is None:
            return
        for idx, nid in enumerate(rec["assignment"]):
            peer = self._peer(nid)
            if peer is not None:
                peer.release_bundle((pg_id, idx))

    def _peer_stats(self, info, what,
                    timeout: Optional[float] = None) -> Any:
        """Stats from any alive node: in-process or over the wire.
        ``timeout`` only applies to the wire path (debug collections
        outlive the default lease timeout)."""
        if info.service is not None:
            return (None if info.service.dead
                    else info.service.node_stats(what))
        peer = self._peer(info.node_id)
        if peer is None:
            return None
        if isinstance(peer, _RemotePeer):
            return peer.node_stats(what, timeout=timeout)
        return peer.node_stats(what)

    def _cluster_info(self, what: str) -> Any:
        if what == "resources_total":
            return self.gcs.cluster_resources()
        if what == "resources_available":
            out: Dict[str, float] = {}
            for info in self.gcs.alive_nodes():
                avail = self._peer_stats(info, "available")
                for k, v in (avail or {}).items():
                    out[k] = out.get(k, 0.0) + v
            return out
        if what == "nodes":
            # resources_available / pending_shapes expose the gossiped
            # view the router consumes (RaySyncer-equivalent): tests and
            # operators can poll the EXACT staleness the scheduler sees
            return [{"node_id": n.node_id, "address": n.address,
                     "resources": n.resources_total, "alive": n.alive,
                     "labels": n.labels,
                     "resources_available": dict(n.resources_available
                                                 or {}),
                     "pending_shapes": list(n.pending_shapes or ())}
                    for n in self.gcs.nodes_snapshot()]
        if what == "store_stats":
            return self.store.stats()
        if what == "workers":
            out = []
            for info in self.gcs.alive_nodes():
                out.extend(self._peer_stats(info, "workers") or [])
            return out
        if what == "config":
            return CONFIG.dump()
        return None

    def _state_query(self, what: str, filters) -> Any:
        if what == "tasks":
            return [ev.__dict__ for ev in self.gcs.list_task_events()]
        if what == "actors":
            return [{"actor_id": aid, "state": rec.state,
                     "name": rec.spec.registered_name,
                     "class_name": rec.spec.name,
                     "node_id": rec.node_id,
                     "num_restarts": rec.num_restarts,
                     "max_restarts": rec.spec.max_restarts}
                    for aid, rec in self.gcs.actors_snapshot()]
        if what == "objects":
            return self._memory_objects()
        if what == "memory":
            # full introspection payload: enriched object rows + current
            # leak findings + per-node store stats
            rows, leaks = self._memory_objects(with_leaks=True)
            stores = {}
            for info in self.gcs.alive_nodes():
                st = self._peer_stats(info, "store")
                if st:
                    stores[info.node_id.hex()] = st
            return {"objects": rows, "leaks": leaks, "stores": stores}
        if what == "placement_groups":
            return [{"pg_id": pid, "state": rec["state"],
                     "bundles": rec["spec"].bundles,
                     "strategy": rec["spec"].strategy}
                    for pid, rec in self.gcs.pgs_snapshot()]
        if what == "jobs":
            return [{"job_id": rec.job_id, "driver_pid": rec.driver_pid,
                     "start_time": rec.start_time,
                     "end_time": rec.end_time}
                    for rec in self.gcs.jobs_snapshot()]
        if what == "cluster_events":
            # full ring: the state API applies filters BEFORE its limit,
            # so a server-side cap would hide older matching rows
            return self.gcs.list_cluster_events(limit=10**9)
        if what == "events_stats":
            # ring occupancy + the eviction counter behind
            # rtpu_events_evicted_total (silent history loss, observable)
            return self.gcs.events_stats()
        if what == "lifecycle":
            return self.gcs.lifecycle_snapshot()
        if what == "metrics_history":
            f = filters or {}
            return self.gcs.metrics_history_query(
                name=f.get("name"), tags=f.get("tags"),
                window=f.get("window"), step=f.get("step"))
        if what == "metrics_history_dump":
            return self.gcs.metrics_history_dump()
        if what == "spans":
            return self.gcs.list_spans(limit=10**9)
        if what == "metrics":
            # merged cluster-wide telemetry; flush our own shards first
            # so a scrape right after local activity is never stale
            telemetry.flush()
            return self.gcs.metrics_snapshot()
        if what == "reconstruct_stats":
            # lineage-reconstruction claim counts per object (the chaos
            # tests assert a lost chain was rebuilt exactly once)
            return self.gcs.reconstruct_stats()
        return None

    def _memory_objects(self, with_leaks: bool = False):
        """Enriched object ledger rows: the control plane's consistent
        snapshot (size, callsite, creator, ref types) merged with each
        node's store-local pin/spill facts (one ``node_stats`` fan-out
        per query — an introspection surface, never a hot path)."""
        mem = self.gcs.memory_state() or {}
        rows = mem.get("objects") or []
        local: Dict[Any, tuple] = {}
        for info in self.gcs.alive_nodes():
            snap = self._peer_stats(info, "objects")
            if snap:
                local.update(snap)
        for row in rows:
            pinned, spilled = local.get(row["object_id"], (0, False))
            row["pinned_in_store"] = pinned
            row["spilled"] = spilled
            if pinned:
                row["ref_types"]["PINNED_IN_STORE"] = pinned
        if with_leaks:
            return rows, mem.get("leaks") or []
        return rows

    def _record_event(self, spec: P.TaskSpec, state: str,
                      pending_args: Optional[List[ObjectID]] = None) -> None:
        self.gcs.record_task_event(TaskEvent(
            task_id=spec.task_id, name=spec.name, state=state,
            node_id=self.node_id, timestamp=time.time(),
            is_actor_task=spec.actor_id is not None,
            # diagnosis inputs for the stall detector
            resources=dict(spec.resources) if spec.resources else None,
            actor_id=spec.actor_id,
            pending_args=pending_args))


def _worker_key(env_key: str, gpus: Optional[List[int]]) -> str:
    """Worker-pool key: the runtime env, and the GPU slots a worker runs
    on. A worker serves only tasks of its own key, so one that ran without
    a card never gets one later, and one bound to a card keeps it."""
    if not gpus:
        return env_key
    return f"{env_key}|gpu:{','.join(map(str, gpus))}"


def _user_sys_paths() -> List[str]:
    """sys.path entries added by the user/driver (script dir, cwd,
    test dirs) — interpreter-owned dirs (stdlib, site-packages) are
    excluded so they never shadow a pip runtime-env venv."""
    import site
    import sysconfig

    interp = set()
    for key in ("stdlib", "platstdlib", "purelib", "platlib"):
        try:
            interp.add(os.path.realpath(sysconfig.get_paths()[key]))
        except KeyError:
            pass
    for p in site.getsitepackages() + [site.getusersitepackages()]:
        interp.add(os.path.realpath(p))
    out = []
    for p in sys.path:
        if not p or not os.path.isdir(p):
            continue
        rp = os.path.realpath(p)
        if any(rp == d or rp.startswith(d + os.sep) for d in interp):
            continue
        if rp.startswith(os.path.realpath(sys.prefix) + os.sep):
            continue
        out.append(p)
    return out


class ActorTaskIds:
    """Deterministic creation-task id per actor."""

    @staticmethod
    def creation_task(spec: P.ActorSpec) -> TaskID:
        return TaskID(TaskID.KIND + spec.actor_id.binary()[1:])
