"""Control plane: cluster membership, actor/job/PG registries, KV, directory.

Equivalent role to the reference's GCS server (``src/ray/gcs/gcs_server/`` —
GcsNodeManager, GcsActorManager, GcsPlacementGroupManager, GcsKVManager,
GcsTaskManager) plus the ownership-based object directory
(``object_manager/ownership_based_object_directory.h``). In this build the
control plane is an in-process, thread-safe object: on a single host it is
embedded in the node service; an in-process multi-node cluster
(``ray_tpu.cluster_utils.Cluster``) shares one instance between node
services, mirroring the reference's single-GCS topology. Cross-host
deployment puts this behind the same framed-socket RPC used everywhere else.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import fieldsan
from . import history as history_mod
from . import locksan
from . import telemetry
from .config import CONFIG
from .ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID
from .object_store import ObjectMeta
from .protocol import ActorSpec, PlacementGroupSpec

M_EVENTS_EVICTED = telemetry.define(
    "counter", "rtpu_events_evicted_total",
    "Cluster events silently dropped from the bounded control-plane "
    "ring (oldest-first, at cluster_events_buffer_size) — silent "
    "history loss made observable")

# Actor lifecycle states (reference: gcs.proto ActorTableData.ActorState)
ACTOR_PENDING = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"

PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_REMOVED = "REMOVED"
# restored from a previous head's journal: the assigned nodes are dead,
# so the record is history only, never a placement target
PG_LOST = "LOST"


@dataclass
class NodeInfo:
    node_id: NodeID
    address: str                      # unix socket path OR "host:port" (TCP)
    resources_total: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    # in-process shortcut to the NodeService (same-process multi-node cluster)
    service: Any = None
    # OS-host identity: node processes on one host share /dev/shm, so
    # same-host peers exchange objects zero-copy by shm name while
    # cross-host peers pull payload bytes (reference: local plasma vs
    # ``object_manager.h:117`` chunked Push/Pull)
    host: str = ""
    # availability reported with heartbeats (RaySyncer-equivalent resource
    # gossip for nodes the scheduler can't snapshot in-process)
    resources_available: Dict[str, float] = field(default_factory=dict)
    # queued resource demand reported with heartbeats (autoscaler input;
    # reference: ResourceDemandScheduler's load report)
    pending_shapes: List[Dict[str, float]] = field(default_factory=list)
    # monotonic version of the availability view (RaySyncer-equivalent,
    # reference: ray_syncer.h:86 versioned snapshots) -- a delayed or
    # re-ordered heartbeat can never roll the view back
    resource_version: int = 0

    def __getstate__(self):
        # the live service object never crosses the wire
        state = dict(self.__dict__)
        state["service"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)


@dataclass
class ActorRecord:
    spec: ActorSpec
    state: str = ACTOR_PENDING
    node_id: Optional[NodeID] = None
    num_restarts: int = 0
    death_reason: str = ""


@dataclass
class JobRecord:
    job_id: JobID
    driver_pid: int
    start_time: float
    end_time: Optional[float] = None


@dataclass
class TaskEvent:
    """One task state transition, kept in a bounded ring for the state API
    (reference: ``GcsTaskManager``, ``gcs_task_manager.h:61``)."""

    task_id: TaskID
    name: str
    state: str
    node_id: Optional[NodeID]
    timestamp: float
    is_actor_task: bool = False
    # diagnosis inputs for the stall detector: the task's resource
    # demand, its target actor, and (for a dep-waiting task) the
    # object ids it still needs
    resources: Optional[Dict[str, float]] = None
    actor_id: Optional[ActorID] = None
    pending_args: Optional[List[ObjectID]] = None


def aggregate_stacks(per_node: Dict[str, List[dict]]) -> List[dict]:
    """Dedup a cluster stack collection: threads with byte-identical
    stacks collapse into one group (at 100+ workers most are parked in
    the same few loops — the interesting stack is the one that differs).
    Sorted most-common first."""
    groups: Dict[tuple, dict] = {}
    for node_hex, dumps in (per_node or {}).items():
        for dump in dumps or []:
            for th in dump.get("threads", ()):
                key = tuple(th.get("frames", ()))
                g = groups.get(key)
                if g is None:
                    g = groups[key] = {"frames": list(key), "count": 0,
                                       "threads": []}
                g["count"] += 1
                g["threads"].append({
                    "node": node_hex,
                    "kind": dump.get("kind"),
                    "pid": dump.get("pid"),
                    "worker_id": dump.get("worker_id"),
                    "thread": th.get("thread_name"),
                })
    return sorted(groups.values(), key=lambda g: -g["count"])


class _CompactingStorage:
    """Wraps a GCS storage backend with size-triggered compaction: a
    long-lived head otherwise grows its journal without bound under
    KV/job churn (every overwrite appends). Compaction runs inline on
    the appending thread, already under the plane lock."""

    _COMPACT_EVERY = 20_000

    def __init__(self, inner, plane):
        self._inner = inner
        self._plane = plane
        self._appends = 0

    def append(self, entry) -> None:
        self._inner.append(entry)
        self._appends += 1
        if self._appends >= self._COMPACT_EVERY:
            self._appends = 0
            self._inner.compact(self._plane._durable_snapshot())

    def load(self):
        return self._inner.load()

    def compact(self, snapshot) -> None:
        self._appends = 0
        self._inner.compact(snapshot)

    def close(self) -> None:
        self._inner.close()


@fieldsan.guarded
class GlobalControlPlane:
    """Thread-safe cluster-wide registries.

    ``storage`` (see ``gcs_storage.py``) makes the durable tables — KV,
    jobs, placement-group specs — survive a head restart, the role
    Redis plays for the reference's GCS
    (``src/ray/gcs/store_client/redis_store_client.h:33``). Volatile
    state (directory, refcounts, heartbeats) dies with the process that
    owned it and is rebuilt by re-registration.
    """

    def __init__(self, storage=None):
        from . import gcs_storage
        self._storage = _CompactingStorage(
            storage or gcs_storage.InMemoryStorage(), self)
        self._lock = locksan.rlock("gcs.plane")
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.actors: Dict[ActorID, ActorRecord] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}
        self.jobs: Dict[JobID, JobRecord] = {}
        self.kv: Dict[bytes, bytes] = {}
        self.placement_groups: Dict[PlacementGroupID, dict] = {}
        # object directory: object -> (node_id, meta)
        self.directory: Dict[ObjectID, Tuple[NodeID, ObjectMeta]] = {}
        # streaming-return counters per producing task (see gen_update)
        self.gen_streams: Dict[TaskID, dict] = {}
        # unplaceable placement groups awaiting capacity (autoscaler
        # input; see register_pending_pg)
        self.pending_pgs: Dict[PlacementGroupID, dict] = {}
        self.task_events: deque = deque(maxlen=CONFIG.task_events_buffer_size)
        self.cluster_events: deque = deque(
            maxlen=CONFIG.cluster_events_buffer_size)
        # node/actor/PG lifecycle state transitions, retained past death
        # in their own bounded ring (task transitions already live in
        # task_events) so `state.timeline()`, the dashboard and debug
        # bundles can render "what the cluster was doing" after the
        # subject is gone
        self.lifecycle_events: deque = deque(
            maxlen=CONFIG.cluster_events_buffer_size)
        self._events_evicted = 0
        # metrics history: multi-resolution retention rings fed by the
        # hosting node's tick (record_history_snapshot); interval digest
        # deltas accumulate here between ticks so each frame carries a
        # true windowed quantile sketch, not a cumulative one
        self.metrics_history = history_mod.MetricsHistory(
            CONFIG.metrics_history_capacity,
            CONFIG.metrics_history_steps,
            CONFIG.metrics_history_max_bytes)
        self._history_interval_digests: Dict[tuple, dict] = {}
        self._history_last = 0.0
        self.spans: deque = deque(maxlen=CONFIG.span_buffer_size)
        # cluster-wide metrics table: merged deltas from every process's
        # telemetry shards (reference analogue: the head's Prometheus
        # scrape target aggregating per-node MetricsAgents)
        self.metrics_counters: Dict[tuple, float] = {}
        self.metrics_gauges: Dict[tuple, tuple] = {}      # key -> (val, ts)
        # retired gauge series -> delete-marker ts: a straggling publish
        # from the dying process (its flusher racing the delete) must
        # not resurrect a popped series, so older-ts values are refused
        # until a genuinely newer set re-creates it
        self._gauge_tombstones: Dict[tuple, float] = {}
        self.metrics_hists: Dict[tuple, dict] = {}
        # key -> digest payload (centroids/count/sum/min/max); merged by
        # the t-digest fold, so per-process quantile sketches combine
        self.metrics_digests: Dict[tuple, dict] = {}
        self.metrics_meta: Dict[str, dict] = {}
        # distinct series refused (cardinality cap) / bucket-conflicted:
        # sets, not event counters — every flush retries the same key
        # and must not inflate the count
        self._metrics_dropped_keys: set = set()
        self._metrics_conflict_keys: set = set()
        self._subscribers: Dict[str, List[Callable[[Any], None]]] = {}
        # distributed reference counting (reference: reference_count.h:61):
        # holder = (node_id_bin, conn_key) — one entry per process holding
        # at least one local ref; pins = in-flight submitted tasks using
        # the object as an argument
        self.ref_holders: Dict[ObjectID, set] = {}
        self.ref_pins: Dict[ObjectID, int] = {}
        self._task_arg_refs: Dict[TaskID, List[ObjectID]] = {}
        self._task_pin_owner: Dict[TaskID, NodeID] = {}
        # returns whose refs all died BEFORE the task sealed them: the
        # seal must free them immediately (fire-and-forget tasks)
        self._freed_early: set = set()
        # refs pickled INSIDE a return object (worker RETURN_REFS):
        # pinned until the return itself is freed, so a nested ref's
        # object survives the gap between the producer's locals dying
        # and a consumer deserializing the return
        self._contained_pins: Dict[ObjectID, List[ObjectID]] = {}
        # RETURN_REFS that arrived before the submitter's REF_REGISTER
        # of the holder (a fast task's worker conn can outrun the
        # driver's buffered edge flush): parked — NOT pinned — until
        # the holder registers, then promoted to a real contained pin.
        # holder_oid -> (oids, parked_at); TTL-swept so a
        # fire-and-forget holder whose register never comes can't
        # accumulate records
        self._contained_pending: Dict[ObjectID, tuple] = {}
        # zero-count objects in their free-grace window (oid -> deadline;
        # see _schedule_zero_locked)
        self._zero_pending: Dict[ObjectID, float] = {}
        # lineage: creating TaskSpec per return object, for reconstruction
        # (reference: object_recovery_manager.h:90), bounded by
        # CONFIG.max_lineage_bytes
        self.lineage: Dict[ObjectID, Any] = {}
        self._lineage_live: Dict[TaskID, int] = {}   # live return oids/spec
        self._lineage_bytes = 0
        # reconstruction claims: only one node rebuilds a lost object, and
        # only objects that were sealed at least once are "lost" (an
        # in-flight first execution must never be duplicated)
        self._sealed_once: set = set()
        self._reconstruct_claims: Dict[ObjectID, float] = {}
        # successful claims per object, for the chaos tests' exactly-once
        # assertion (a depth-N chain rebuilds each link once)
        self._reconstruct_counts: Dict[ObjectID, int] = {}
        # checkpointable actors: actor -> (seq, blob, ts). Latest only —
        # the control plane holds the blob (NOT the checkpointing
        # node's object store) so a node-death restart on another node
        # still restores; GC'd when the actor reaches ACTOR_DEAD
        self.actor_checkpoints: Dict[ActorID, tuple] = {}
        # specs of restartable actors whose node died, awaiting a
        # claimant (see claim_actor_reroute)
        self._actor_reroutes: Dict[ActorID, Any] = {}
        # stall detector state: last sweep time + cause already warned
        # per task (re-warn only when the diagnosed cause changes)
        self._stall_last_sweep = 0.0
        self._stall_warned: Dict[TaskID, str] = {}
        # object provenance: oid -> (callsite, creator) captured at
        # put()/.remote() time (reference: ReferenceCounter callsites
        # behind RAY_record_ref_creation_sites); dies with the object
        self.obj_provenance: Dict[ObjectID, tuple] = {}
        # leak-sweep state: current findings, first-seen time of
        # zero-holder-but-pinned objects, and the cause already warned
        # per object (emit-once until the cause changes)
        self._leaks: Dict[ObjectID, dict] = {}
        self._pinned_zero_since: Dict[ObjectID, float] = {}
        self._leak_warned: Dict[ObjectID, str] = {}
        self._leak_last_sweep = 0.0
        self._restore()

    # ------------------------------------------------------- persistence
    # concurrency: requires(gcs.plane)
    def _restore(self) -> None:
        """Replay the journal into the durable tables (no-op in-memory)."""
        for table, op, payload in self._storage.load():
            if table == "kv":
                if op == "put" and self._kv_durable(payload[0]):
                    self.kv[payload[0]] = payload[1]
                elif op == "del":
                    self.kv.pop(payload, None)
            elif table == "jobs" and op == "put":
                # a job still "running" in the journal died with the old
                # head (its driver is gone); stamp it finished so it
                # doesn't show as live forever
                if payload.end_time is None:
                    payload.end_time = time.time()
                self.jobs[payload.job_id] = payload
            elif table == "pgs":
                if op == "put":
                    # the nodes behind the old assignment died with the
                    # old head: keep the record for history/inspection
                    # but never as a live placement target
                    rec = dict(payload)
                    rec["state"] = "LOST"
                    self.placement_groups[payload["spec"].pg_id] = rec
                elif op == "del":
                    self.placement_groups.pop(payload, None)

    def _durable_snapshot(self) -> list:
        with self._lock:
            return ([("kv", "put", (k, v)) for k, v in self.kv.items()
                     if self._kv_durable(k)]
                    + [("jobs", "put", r) for r in self.jobs.values()]
                    + [("pgs", "put", r)
                       for r in self.placement_groups.values()])

    def compact_storage(self) -> None:
        # under the plane lock: an append between snapshot and the
        # journal rename would be destroyed by the rename (a kv_put
        # that returned True silently losing durability)
        with self._lock:
            self._storage.compact(self._durable_snapshot())

    def close_storage(self) -> None:
        self._storage.close()

    # ------------------------------------------------------------- nodes
    def register_node(self, info: NodeInfo) -> None:
        # re-stamp on OUR clock: a remote registrant's monotonic stamp is
        # incomparable with this host's and could instantly trip the
        # heartbeat sweeper
        info.last_heartbeat = time.monotonic()
        with self._lock:
            self.nodes[info.node_id] = info
            self._record_lifecycle_locked("node", info.node_id.hex(),
                                          "ALIVE", address=info.address)
        self.publish("NODE", {"node_id": info.node_id, "state": "ALIVE"})

    def remove_node(self, node_id: NodeID, reason: str = "") -> None:
        dead_actors: List[ActorID] = []
        restart_actors: List[ActorID] = []
        with self._lock:
            info = self.nodes.get(node_id)
            if info is None:
                return
            info.alive = False
            self._record_lifecycle_locked("node", node_id.hex(), "DEAD",
                                          reason=reason)
            # drop directory entries whose only location was this node
            lost = [oid for oid, (nid, _) in self.directory.items()
                    if nid == node_id]
            for oid in lost:
                del self.directory[oid]
            for aid, rec in self.actors.items():
                if rec.node_id != node_id or rec.state == ACTOR_DEAD:
                    continue
                max_r = rec.spec.max_restarts
                if max_r == -1 or rec.num_restarts < max_r:
                    # restartable actor lost its whole node: hand the
                    # spec to exactly one surviving claimant (reference:
                    # GcsActorManager::OnNodeDead rescheduling)
                    rec.num_restarts += 1
                    rec.state = ACTOR_RESTARTING
                    rec.node_id = None
                    self._actor_reroutes[aid] = rec.spec
                    restart_actors.append(aid)
                else:
                    dead_actors.append(aid)
            # release arg pins whose submitting node can never unpin
            orphans = [tid for tid, owner in self._task_pin_owner.items()
                       if owner == node_id]
            for tid in orphans:
                self._unpin_locked(tid)
        self.publish("NODE", {"node_id": node_id, "state": "DEAD",
                              "reason": reason})
        # drain the released pins even if no further ref edges arrive
        # (e.g. the cluster just collapsed to its last node)
        self.sweep_ref_zeros()
        for aid in restart_actors:
            self.publish("ACTOR", {"actor_id": aid,
                                   "state": ACTOR_RESTARTING,
                                   "reroute": True})
        for aid in dead_actors:
            self.set_actor_state(aid, ACTOR_DEAD,
                                 reason=f"node {node_id} died")

    def claim_actor_reroute(self, actor_id: ActorID):
        """Exactly-once handoff of a node-death restart: nodes race on
        the ACTOR/reroute event; the first claim wins the spec."""
        with self._lock:
            return self._actor_reroutes.pop(actor_id, None)

    def requeue_actor_reroute(self, actor_id: ActorID, spec) -> None:
        """A claimant failed mid-restart: put the spec back and re-ask."""
        with self._lock:
            self._actor_reroutes[actor_id] = spec
        self.publish("ACTOR", {"actor_id": actor_id,
                               "state": ACTOR_RESTARTING, "reroute": True})

    def alive_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self.nodes.values() if n.alive]

    def heartbeat(self, node_id: NodeID,
                  resources_available: Optional[Dict[str, float]] = None,
                  pending_shapes: Optional[List[Dict[str, float]]] = None,
                  version: Optional[int] = None) -> None:
        """Liveness + versioned resource sync. A payload carrying a
        version at or below the stored one is a delayed duplicate: it
        refreshes liveness but must NOT roll the availability view back
        (reference: RaySyncer versioned snapshots, ray_syncer.h:86).
        ``resources_available=None`` is the delta protocol "nothing
        changed" ping -- senders only ship the dict on change."""
        with self._lock:
            info = self.nodes.get(node_id)
            if info:
                info.last_heartbeat = time.monotonic()
                stale = (version is not None
                         and info.resource_version > 0
                         and version <= info.resource_version)
                if not stale:
                    if version is not None:
                        info.resource_version = version
                    if resources_available is not None:
                        info.resources_available = resources_available
                    if pending_shapes is not None:
                        info.pending_shapes = pending_shapes
        # heartbeats double as the grace sweeper so pending frees drain
        # even when no further ref edges arrive
        self.sweep_ref_zeros()

    def get_node(self, node_id: NodeID) -> Optional[NodeInfo]:
        with self._lock:
            return self.nodes.get(node_id)

    def nodes_snapshot(self) -> List[NodeInfo]:
        with self._lock:
            return list(self.nodes.values())

    def cluster_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.alive_nodes():
            for k, v in n.resources_total.items():
                out[k] = out.get(k, 0.0) + v
        return out

    # ------------------------------------------------------------ actors
    def register_actor(self, spec: ActorSpec) -> ActorRecord:
        rec = ActorRecord(spec=spec)
        with self._lock:
            if spec.registered_name:
                key = (spec.namespace, spec.registered_name)
                if key in self.named_actors:
                    raise ValueError(
                        f"actor name {spec.registered_name!r} already taken "
                        f"in namespace {spec.namespace!r}")
                self.named_actors[key] = spec.actor_id
            self.actors[spec.actor_id] = rec
        return rec

    def set_actor_state(self, actor_id: ActorID, state: str,
                        node_id: Optional[NodeID] = None,
                        reason: str = "",
                        count_restart: bool = False) -> None:
        with self._lock:
            rec = self.actors.get(actor_id)
            if rec is None:
                return
            if rec.state != state:
                self._record_lifecycle_locked(
                    "actor", actor_id.hex(), state,
                    class_name=rec.spec.name, reason=reason or None)
            rec.state = state
            if count_restart:
                # worker-level restarts and node-death reroutes share ONE
                # budget: max_restarts bounds their SUM
                rec.num_restarts += 1
            if node_id is not None:
                rec.node_id = node_id
            if reason:
                rec.death_reason = reason
            if state == ACTOR_DEAD and rec.spec.registered_name:
                self.named_actors.pop(
                    (rec.spec.namespace, rec.spec.registered_name), None)
            if state == ACTOR_DEAD:
                # terminal: nothing will ever restore this checkpoint
                self.actor_checkpoints.pop(actor_id, None)
        self.publish("ACTOR", {"actor_id": actor_id, "state": state,
                               "reason": reason})

    def get_actor(self, actor_id: ActorID) -> Optional[ActorRecord]:
        with self._lock:
            return self.actors.get(actor_id)

    def lookup_named_actor(self, name: str,
                           namespace: str = "default") -> Optional[ActorRecord]:
        with self._lock:
            actor_id = self.named_actors.get((namespace, name))
            return self.actors.get(actor_id) if actor_id else None

    # ------------------------------------------------ actor checkpoints
    # Opt-in checkpointable-actor state (save_checkpoint/
    # restore_checkpoint): one latest blob per actor, seq-guarded so a
    # pre-death straggler's late save can never roll a restarted
    # actor's newer snapshot back.

    def save_actor_checkpoint(self, actor_id: ActorID, seq: int,
                              blob: bytes) -> bool:
        with self._lock:
            cur = self.actor_checkpoints.get(actor_id)
            if cur is not None and cur[0] >= seq:
                return False
            self.actor_checkpoints[actor_id] = (int(seq), bytes(blob),
                                                time.time())
        return True

    def get_actor_checkpoint(self, actor_id: ActorID
                             ) -> Optional[Tuple[int, bytes]]:
        with self._lock:
            cur = self.actor_checkpoints.get(actor_id)
            return None if cur is None else (cur[0], cur[1])

    # Durable mutations journal INSIDE the plane lock: an append racing
    # a later append for the same key would otherwise persist in the
    # wrong order, and a restart would restore a value the live cluster
    # never ended on. FileStorage.append is a short local write with its
    # own lock and never calls back into the plane, so no deadlock.

    # -------------------------------------------------------------- jobs
    def register_job(self, rec: JobRecord) -> None:
        with self._lock:
            self.jobs[rec.job_id] = rec
            self._storage.append(("jobs", "put", rec))

    def finish_job(self, job_id: JobID) -> None:
        with self._lock:
            rec = self.jobs.get(job_id)
            if rec:
                rec.end_time = time.time()
                self._storage.append(("jobs", "put", rec))

    # ---------------------------------------------------------------- kv
    # never journaled: per-session function blobs (``fn:``, megabytes of
    # pickled code dead with their job) and runtime discovery keys
    # (``__rtpu_*`` — a restarted head re-publishes fresh addresses, and
    # restoring stale ones would point drivers at dead sockets)
    _VOLATILE_KV_PREFIXES = (b"fn:", b"__rtpu_")

    def _kv_durable(self, key: bytes) -> bool:
        return not key.startswith(self._VOLATILE_KV_PREFIXES)

    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True) -> bool:
        with self._lock:
            if not overwrite and key in self.kv:
                return False
            self.kv[key] = value
            if self._kv_durable(key):
                self._storage.append(("kv", "put", (key, value)))
        return True

    def kv_get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self.kv.get(key)

    def kv_del(self, key: bytes) -> None:
        with self._lock:
            self.kv.pop(key, None)
            if self._kv_durable(key):
                self._storage.append(("kv", "del", key))

    def kv_keys(self, prefix: bytes) -> List[bytes]:
        with self._lock:
            return [k for k in self.kv if k.startswith(prefix)]

    # ---------------------------------------------------------- directory
    def publish_location(self, object_id: ObjectID, node_id: NodeID,
                         meta: ObjectMeta) -> None:
        with self._lock:
            self.directory[object_id] = (node_id, meta)
            self._sealed_once.add(object_id)
            self._reconstruct_claims.pop(object_id, None)
            garbage = object_id in self._freed_early
            if garbage:
                self._freed_early.discard(object_id)
        if garbage:
            # every ref died before the value was sealed (fire-and-forget
            # task): the fresh copy is garbage on arrival
            self.publish("REF_ZERO", {"object_id": object_id,
                                      "node_id": node_id})

    def lookup_location(
            self, object_id: ObjectID) -> Optional[Tuple[NodeID, ObjectMeta]]:
        with self._lock:
            return self.directory.get(object_id)

    def drop_location(self, object_id: ObjectID) -> None:
        with self._lock:
            self.directory.pop(object_id, None)
            # explicit free (ray_tpu free()) of a return releases its
            # nested-ref pins; the refcount zero path already popped
            # them in _zero_check, so this is a no-op there
            self._release_contained_locked(object_id)
        self.sweep_ref_zeros()

    # ------------------------------------------------- pending gangs
    # Placement groups that could not be packed onto the live cluster.
    # The client retries create_pg while blocked in ready(); these
    # records make that demand visible to the autoscaler, which is THE
    # scaling driver for gang workloads on TPU (reference:
    # ``resource_demand_scheduler.py:102`` feeds pending placement
    # groups into scale-up). last_attempt is refreshed per retry so a
    # vanished driver's gang stops driving scale-up (staleness filter).

    # purge records this long after their last retry: abandoned gangs
    # (ready() timeout, dead driver) must not leak for the cluster's
    # lifetime. Well past the autoscaler's 5s staleness bar.
    PENDING_PG_TTL_S = 60.0

    def register_pending_pg(self, spec) -> None:
        with self._lock:
            self._purge_stale_pending_pgs()
            self.pending_pgs[spec.pg_id] = {"spec": spec,
                                            "last_attempt": time.time()}

    def clear_pending_pg(self, pg_id: PlacementGroupID) -> None:
        with self._lock:
            self.pending_pgs.pop(pg_id, None)

    def pending_pgs_snapshot(self) -> List[dict]:
        with self._lock:
            self._purge_stale_pending_pgs()
            return [dict(rec) for rec in self.pending_pgs.values()]

    # concurrency: requires(gcs.plane)
    def _purge_stale_pending_pgs(self) -> None:
        cutoff = time.time() - self.PENDING_PG_TTL_S
        for pg_id in [p for p, rec in self.pending_pgs.items()
                      if rec["last_attempt"] < cutoff]:
            del self.pending_pgs[pg_id]

    # ------------------------------------------------- generator streams
    # Streaming-return bookkeeping (reference: the owner-side generator
    # state driven by ReportGeneratorItemReturns,
    # ``core_worker.proto:396``). Item payloads are ordinary directory
    # objects; this records only produced/consumed/done counters so a
    # consumer on any node can pace the producer.

    def gen_update(self, task_id: TaskID, produced: int) -> None:
        with self._lock:
            st = self.gen_streams.setdefault(
                task_id, {"produced": 0, "consumed": 0, "done": False,
                          "count": None, "error": None})
            if produced > st["produced"]:
                st["produced"] = produced
        self.publish("GEN", (task_id, "produced", produced))

    def gen_done(self, task_id: TaskID, count: int,
                 error: Optional[bytes]) -> None:
        with self._lock:
            st = self.gen_streams.setdefault(
                task_id, {"produced": 0, "consumed": 0, "done": False,
                          "count": None, "error": None})
            st["done"] = True
            st["count"] = count
            st["error"] = error
            st["produced"] = max(st["produced"], count)
        self.publish("GEN", (task_id, "done", count))

    def gen_consumed(self, task_id: TaskID, consumed: int) -> None:
        with self._lock:
            # create-on-miss: a GEN_CLOSE can arrive before the first
            # produced item, and dropping its infinite credit would
            # wedge the producer at the backpressure window forever
            st = self.gen_streams.setdefault(
                task_id, {"produced": 0, "consumed": 0, "done": False,
                          "count": None, "error": None})
            if consumed <= st["consumed"]:
                return
            st["consumed"] = consumed
        self.publish("GEN", (task_id, "consumed", consumed))

    def gen_get(self, task_id: TaskID) -> Optional[dict]:
        with self._lock:
            st = self.gen_streams.get(task_id)
            return dict(st) if st is not None else None

    def gen_drop(self, task_id: TaskID) -> None:
        with self._lock:
            self.gen_streams.pop(task_id, None)

    # ----------------------------------------------------- placement groups
    def register_pg(self, spec: PlacementGroupSpec,
                    assignment: List[NodeID]) -> None:
        rec = {"spec": spec, "state": PG_CREATED, "assignment": assignment}
        with self._lock:
            self.placement_groups[spec.pg_id] = rec
            self._record_lifecycle_locked("placement_group",
                                          spec.pg_id.hex(), PG_CREATED)
            self._storage.append(("pgs", "put", rec))

    def get_pg(self, pg_id: PlacementGroupID) -> Optional[dict]:
        with self._lock:
            return self.placement_groups.get(pg_id)

    def remove_pg(self, pg_id: PlacementGroupID) -> Optional[dict]:
        with self._lock:
            rec = self.placement_groups.pop(pg_id, None)
            if rec:
                rec["state"] = PG_REMOVED
                self._record_lifecycle_locked("placement_group",
                                              pg_id.hex(), PG_REMOVED)
                self._storage.append(("pgs", "del", pg_id))
        return rec

    # ------------------------------------------------- reference counting
    def ref_register(self, oid: ObjectID, holder: tuple) -> None:
        with self._lock:
            self.ref_holders.setdefault(oid, set()).add(holder)
            # a borrow landed during the zero-grace window: cancel the
            # pending free (see _schedule_zero_locked)
            self._zero_pending.pop(oid, None)
            pend = self._contained_pending.pop(oid, None)
            if pend is not None:
                # a RETURN_REFS raced ahead of this register (see
                # pin_contained): promote the parked containment now
                # that the holder is live
                self._pin_contained_locked(oid, pend[0])

    def ref_drop(self, oid: ObjectID, holder: tuple) -> None:
        with self._lock:
            holders = self.ref_holders.get(oid)
            if holders is None:
                return   # never tracked (or already freed): not ours
            holders.discard(holder)
            self._schedule_zero_locked(oid)
        self.sweep_ref_zeros()

    def drop_all_refs(self, holder: tuple, oids: List[ObjectID]) -> None:
        """A holder process died/disconnected: drop everything it held."""
        with self._lock:
            for oid in oids:
                holders = self.ref_holders.get(oid)
                if holders is None:
                    continue
                holders.discard(holder)
                self._schedule_zero_locked(oid)
        self.sweep_ref_zeros()

    # concurrency: requires(gcs.plane)
    def _schedule_zero_locked(self, oid: ObjectID) -> None:
        """Count hit zero: schedule the free after a short grace window
        instead of freeing now. A ref travelling between processes (a
        queue actor returns [ref] and drops its copy while the consumer's
        REGISTER is still in flight) briefly reads as zero; freeing
        immediately would vaporize the object under the borrower.
        Reference analogue: the owner-hosted borrower protocol
        (WaitForRefRemoved, ``reference_count.h:61``) — the centralized
        design absorbs edge races with time instead of per-borrower
        chains."""
        holders = self.ref_holders.get(oid)
        if holders is None or holders or self.ref_pins.get(oid, 0) > 0:
            return
        self._zero_pending.setdefault(
            oid, time.time() + CONFIG.ref_zero_grace_ms / 1000.0)

    def sweep_ref_zeros(self) -> None:
        """Publish frees whose grace expired with the count still zero.
        Called from the edge paths and from heartbeats (so zeros drain
        even on an otherwise-idle cluster)."""
        if not self._zero_pending:
            return          # lock-free fast path: called per edge event
        freed = []
        now = time.time()
        with self._lock:
            if not self._zero_pending:
                return
            for oid, deadline in list(self._zero_pending.items()):
                if deadline > now:
                    continue
                del self._zero_pending[oid]
                z = self._zero_check(oid)
                if z is not None:
                    freed.append(z)
        for z in freed:
            self.publish("REF_ZERO", z)

    def pin_task_args(self, task_id: TaskID, oids: List[ObjectID],
                      owner_node: Optional[NodeID] = None) -> None:
        """Submitted-task references: args keep their objects alive for
        the task's lifetime even if every Python ref dies meanwhile.
        ``owner_node`` (the submitting node) lets ``remove_node`` release
        pins whose owner can never send the unpin."""
        with self._lock:
            self._task_arg_refs[task_id] = list(oids)
            if owner_node is not None:
                self._task_pin_owner[task_id] = owner_node
            for oid in oids:
                self.ref_pins[oid] = self.ref_pins.get(oid, 0) + 1

    def unpin_task_args(self, task_id: TaskID) -> None:
        with self._lock:
            self._unpin_locked(task_id)
        self.sweep_ref_zeros()

    # concurrency: requires(gcs.plane)
    def _unpin_locked(self, task_id: TaskID) -> None:
        self._task_pin_owner.pop(task_id, None)
        for oid in self._task_arg_refs.pop(task_id, ()):
            n = self.ref_pins.get(oid, 1) - 1
            if n <= 0:
                self.ref_pins.pop(oid, None)
            else:
                self.ref_pins[oid] = n
            self._schedule_zero_locked(oid)

    def pin_contained(self, holder_oid: ObjectID,
                      oids: List[ObjectID]) -> None:
        """A task return carries these refs inside its payload: keep
        their objects alive until the return object is freed. A repeat
        for the same return (task retry) replaces the previous pin set."""
        with self._lock:
            if self.ref_holders.get(holder_oid) is None:
                # Two indistinguishable cases: the return's refs already
                # died (fire-and-forget — nested objects are garbage,
                # don't pin) OR a fast task's RETURN_REFS outran the
                # submitter's buffered REF_REGISTER edge. Park WITHOUT
                # pinning: a late register promotes it (see
                # ref_register); a register that never comes is
                # TTL-swept, so garbage stays garbage either way.
                self._contained_pending[holder_oid] = (list(oids),
                                                       time.time())
                return
            self._pin_contained_locked(holder_oid, oids)

    # concurrency: requires(gcs.plane)
    def _pin_contained_locked(self, holder_oid: ObjectID,
                              oids: List[ObjectID]) -> None:
        self._release_contained_locked(holder_oid)
        self._contained_pins[holder_oid] = list(oids)
        for oid in oids:
            self.ref_pins[oid] = self.ref_pins.get(oid, 0) + 1
            self._zero_pending.pop(oid, None)

    # concurrency: requires(gcs.plane)
    def _release_contained_locked(self, holder_oid: ObjectID) -> None:
        self._contained_pending.pop(holder_oid, None)
        for oid in self._contained_pins.pop(holder_oid, ()):
            n = self.ref_pins.get(oid, 1) - 1
            if n <= 0:
                self.ref_pins.pop(oid, None)
                self._schedule_zero_locked(oid)
            else:
                self.ref_pins[oid] = n

    # concurrency: requires(gcs.plane)
    def _zero_check(self, oid: ObjectID):
        """Callers hold _lock. Returns a REF_ZERO payload when the object
        became garbage: it was tracked, no process holds a ref, and no
        in-flight task uses it."""
        holders = self.ref_holders.get(oid)
        if holders is None or holders or self.ref_pins.get(oid, 0) > 0:
            return None
        del self.ref_holders[oid]
        # provenance, leak-sweep and reconstruction-audit state die
        # with the object
        self._reconstruct_counts.pop(oid, None)
        self.obj_provenance.pop(oid, None)
        self._leaks.pop(oid, None)
        self._pinned_zero_since.pop(oid, None)
        self._leak_warned.pop(oid, None)
        # nested refs this return carried die with it (cascading via
        # their own zero-grace)
        self._release_contained_locked(oid)
        spec = self.lineage.pop(oid, None)
        if spec is not None:
            # spec cost was charged once for all returns: release it when
            # the last live return goes
            live = self._lineage_live.get(spec.task_id, 1) - 1
            if live <= 0:
                self._lineage_live.pop(spec.task_id, None)
                self._lineage_bytes -= self._spec_cost(spec)
            else:
                self._lineage_live[spec.task_id] = live
        loc = self.directory.get(oid)
        if loc is None:
            # refs died before the task sealed its return: mark so the
            # eventual seal frees the value instead of leaking it
            self._freed_early.add(oid)
        return {"object_id": oid,
                "node_id": loc[0] if loc is not None else None}

    # --------------------------- object provenance & memory introspection
    # Reference surface: ``ray memory`` — the ReferenceCounter's
    # per-ref creation callsites (RAY_record_ref_creation_sites) plus
    # ref-type classification (LOCAL_REFERENCE / USED_BY_PENDING_TASK /
    # CAPTURED_IN_OBJECT / ACTOR_HANDLE / PINNED_IN_STORE). Everything
    # here derives from state the plane already keeps (ref_holders,
    # ref_pins, _task_arg_refs, _contained_pins, actor specs); the only
    # new ingestion is the OBJ_PROVENANCE callsite batches.

    _PROVENANCE_LIMIT = 200_000

    def record_provenance(self, entries: List[tuple]) -> None:
        """Merge one client's creation-callsite batch: (oid, callsite,
        creator) triples. Capped so runaway id churn can't grow the
        head without bound; the leak sweep GCs entries whose object is
        gone."""
        with self._lock:
            table = self.obj_provenance
            for oid, callsite, creator in entries:
                if oid in table or len(table) < self._PROVENANCE_LIMIT:
                    table[oid] = (callsite, creator)

    def objects_info(self, oids: List[ObjectID]) -> Dict[ObjectID, dict]:
        """Size + location + provenance for a batch of ids in ONE call
        (the OOM autopsy names a victim's top objects without an RPC
        per id)."""
        out: Dict[ObjectID, dict] = {}
        with self._lock:
            for oid in oids:
                loc = self.directory.get(oid)
                prov = self.obj_provenance.get(oid)
                out[oid] = {
                    "object_id": oid,
                    "size": loc[1].size if loc is not None else None,
                    "node_id": loc[0] if loc is not None else None,
                    "callsite": prov[0] if prov else None,
                    "creator": prov[1] if prov else None,
                }
        return out

    def memory_state(self) -> dict:
        """One consistent snapshot of the object ledger: every object
        the plane knows (directory entries, held refs, pinned args,
        contained pins) with its size, creation callsite and a
        per-holder reference-type breakdown. The raw material behind
        ``state.list_objects()`` / ``state.memory_summary()`` /
        ``GET /api/memory``."""
        with self._lock:
            task_pins: Dict[ObjectID, int] = {}
            for oids in self._task_arg_refs.values():
                for oid in oids:
                    task_pins[oid] = task_pins.get(oid, 0) + 1
            contained: Dict[ObjectID, int] = {}
            for oids in self._contained_pins.values():
                for oid in oids:
                    contained[oid] = contained.get(oid, 0) + 1
            actor_returns: Dict[ObjectID, ActorID] = {}
            for aid, rec in self.actors.items():
                cr = rec.spec.creation_return_id
                if cr is not None and rec.state != ACTOR_DEAD:
                    actor_returns[cr] = aid
            universe = (set(self.directory) | set(self.ref_holders)
                        | set(task_pins) | set(contained))
            rows: List[dict] = []
            for oid in universe:
                loc = self.directory.get(oid)
                prov = self.obj_provenance.get(oid)
                holders = self.ref_holders.get(oid) or ()
                ref_types: Dict[str, int] = {}
                if holders:
                    ref_types["LOCAL_REFERENCE"] = len(holders)
                if task_pins.get(oid):
                    ref_types["USED_BY_PENDING_TASK"] = task_pins[oid]
                if contained.get(oid):
                    ref_types["CAPTURED_IN_OBJECT"] = contained[oid]
                if oid in actor_returns:
                    ref_types["ACTOR_HANDLE"] = 1
                rows.append({
                    "object_id": oid,
                    "node_id": loc[0] if loc is not None else None,
                    "size": loc[1].size if loc is not None else None,
                    "callsite": prov[0] if prov else None,
                    "creator": prov[1] if prov else None,
                    "ref_types": ref_types,
                    "pins": self.ref_pins.get(oid, 0),
                    "leaked": oid in self._leaks,
                })
            return {"objects": rows,
                    "leaks": [dict(r) for r in self._leaks.values()]}

    def sweep_object_leaks(self):
        """Rate-limited leak sweep: flag objects whose EVERY ref holder
        lives on a dead node (the node died before its processes could
        drop their refs — nothing will ever free them), and objects
        that sat pinned with zero holders past
        ``memory_leak_pinned_ttl_s`` (a task pin / contained pin whose
        release path is wedged). Returns ``(new_records, total)`` —
        ``new_records`` are findings not yet warned about (the caller
        emits them as OBJECT_LEAK WARNING events), ``total`` the
        current finding count for the gauge; ``([], None)`` when
        rate-limited or disabled."""
        interval = CONFIG.memory_leak_sweep_interval_s
        # interval<=0 disables leak FINDING only: the bookkeeping GC
        # below (parked containments, dead provenance entries) must
        # still run or a long-lived head grows without bound
        gc_only = interval <= 0
        period = interval if interval > 0 else 30.0
        now = time.time()
        out: List[dict] = []
        with self._lock:
            if now - self._leak_last_sweep < period:
                return [], None
            self._leak_last_sweep = now
            alive = {n.node_id.binary() for n in self.nodes.values()
                     if n.alive}
            ttl = CONFIG.memory_leak_pinned_ttl_s
            leaks: Dict[ObjectID, dict] = {}
            for oid, holders in (() if gc_only
                                 else self.ref_holders.items()):
                cause = None
                age = None
                if holders:
                    # holder = (node_id_binary, conn_key): a holder on
                    # a live node is (or will be) cleaned by that
                    # node's conn-close path; one on a dead node never
                    if all(h[0] not in alive for h in holders):
                        cause = "dead_holders"
                    self._pinned_zero_since.pop(oid, None)
                elif self.ref_pins.get(oid, 0) > 0:
                    since = self._pinned_zero_since.setdefault(oid, now)
                    age = now - since
                    if ttl > 0 and age >= ttl:
                        cause = "pinned_no_holder"
                if cause is None:
                    continue
                loc = self.directory.get(oid)
                prov = self.obj_provenance.get(oid)
                rec = {"object_id": oid, "cause": cause,
                       "node_id": loc[0] if loc is not None else None,
                       "size": loc[1].size if loc is not None else None,
                       "callsite": prov[0] if prov else None,
                       "creator": prov[1] if prov else None,
                       "holders": len(holders),
                       "pins": self.ref_pins.get(oid, 0)}
                if age is not None:
                    rec["age_s"] = round(age, 1)
                leaks[oid] = rec
                if self._leak_warned.get(oid) != cause:
                    self._leak_warned[oid] = cause
                    out.append(dict(rec))
            self._leaks = leaks
            # GC sweep state + provenance for objects that are fully
            # gone (freed, or never tracked at all)
            for d in (self._leak_warned, self._pinned_zero_since):
                for oid in [o for o in d if o not in self.ref_holders]:
                    del d[oid]
            for oid in [o for o in self.obj_provenance
                        if o not in self.ref_holders
                        and o not in self.directory
                        and not self.ref_pins.get(o)]:
                del self.obj_provenance[oid]
            # parked containments whose holder never registered
            # (fire-and-forget returns): drop after a generous TTL
            cutoff = now - 30.0
            for oid in [o for o, (_c, t) in
                        self._contained_pending.items() if t < cutoff]:
                del self._contained_pending[oid]
            return out, len(leaks)

    # --------------------------------------------------------------- lineage
    @staticmethod
    def _spec_cost(spec) -> int:
        cost = 256
        for slot, val in list(spec.args) + list(spec.kwargs.values()):
            if slot == "v":
                cost += len(val)
        return cost

    def record_lineage(self, spec) -> None:
        cost = self._spec_cost(spec)
        with self._lock:
            if spec.task_id in self._lineage_live:
                return   # resubmission of a recorded task
            if self._lineage_bytes + cost > CONFIG.max_lineage_bytes:
                return   # over budget: this object won't be reconstructable
            for oid in spec.return_ids:
                self.lineage[oid] = spec
            self._lineage_live[spec.task_id] = len(spec.return_ids)
            self._lineage_bytes += cost

    def get_lineage(self, oid: ObjectID):
        with self._lock:
            return self.lineage.get(oid)

    def claim_lineage(self, oid: ObjectID,
                      claim_timeout_s: float = 60.0):
        """Atomic reconstruction claim: returns the creating TaskSpec only
        if the object is genuinely LOST — sealed at least once, currently
        locationless — and nobody else claimed it recently. One winner
        per loss; an in-flight first execution is never duplicated."""
        with self._lock:
            if oid in self.directory or oid not in self._sealed_once:
                return None
            spec = self.lineage.get(oid)
            if spec is None:
                return None
            now = time.monotonic()
            t = self._reconstruct_claims.get(oid)
            if t is not None and now - t < claim_timeout_s:
                return None
            self._reconstruct_claims[oid] = now
            self._reconstruct_counts[oid] = (
                self._reconstruct_counts.get(oid, 0) + 1)
            # bounded audit trail: oldest rows fall off (claims are
            # rare — node deaths — but a long-lived head must not
            # accumulate a row per reconstructed object forever)
            while len(self._reconstruct_counts) > 4096:
                self._reconstruct_counts.pop(
                    next(iter(self._reconstruct_counts)))
            return spec

    def reconstruct_stats(self) -> Dict[str, int]:
        """Successful lineage-reconstruction claims per object (hex) —
        the claim gate's audit trail: the chaos tests assert each lost
        link of a produce->transform->consume chain was rebuilt exactly
        once."""
        with self._lock:
            return {oid.hex(): n
                    for oid, n in self._reconstruct_counts.items()}

    # --------------------------------------------------------- snapshots
    # Explicit copies for state queries: both the in-process plane and the
    # remote client expose these, so node.py never touches raw attributes.
    def actors_snapshot(self) -> List[Tuple[ActorID, ActorRecord]]:
        with self._lock:
            return list(self.actors.items())

    def jobs_snapshot(self) -> List[JobRecord]:
        with self._lock:
            return list(self.jobs.values())

    def gang_hosts(self) -> set:
        """Nodes holding live placement-group bundles. A gang node is
        never drainable while its PG exists — the reservation holds
        resources whether or not tasks currently run (reference: PG
        resources stay claimed until removal)."""
        out = set()
        with self._lock:
            for rec in self.placement_groups.values():
                if rec.get("state") == PG_CREATED:
                    out.update(rec.get("assignment") or ())
        return out

    def directory_snapshot(self) -> List[Tuple[ObjectID,
                                               Tuple[NodeID, ObjectMeta]]]:
        with self._lock:
            return list(self.directory.items())

    def pgs_snapshot(self) -> List[Tuple[PlacementGroupID, dict]]:
        with self._lock:
            return list(self.placement_groups.items())

    # ------------------------------------------------------- stall detector
    # Reference analogue: the task-event stall warnings GcsTaskManager
    # derives from tasks stuck in a non-terminal state. The sweep runs
    # on the plane (it owns every diagnosis input: task events, the
    # directory, actor states, per-node availability) and is triggered
    # from the hosting node's tick; emission goes through that node's
    # EventLogger so stalls land in the events JSONL AND the ring.

    _STALL_PENDING_STATES = ("PENDING_ARGS_AVAIL",
                             "PENDING_NODE_ASSIGNMENT")

    def maybe_sweep_stalls(self, coll_probe=None) -> List[dict]:
        """Rate-limited sweep: flag tasks sitting in a pending state (or
        RUNNING) past the configured thresholds, each with a diagnosed
        *cause* — unsatisfiable resource shape, a never-ready dependency,
        a dead target actor, a collective wait that outlived half its
        timeout (``collective_stuck``, see below), or plain queue
        saturation. Returns the newly-diagnosed records; the caller
        emits them as WARNING cluster events.

        ``coll_probe`` (provided by the hosting node) takes a list of
        ``(TaskEvent, age_s)`` RUNNING candidates older than
        ``collective_timeout_s / 2`` and returns ``(ev, cause, message)``
        triples for the ones whose worker stack shows them parked in a
        collective wait. It fans out RPCs, so it runs strictly OUTSIDE
        the plane lock — candidates are gathered locked, probed
        unlocked, and de-duplicated through ``_stall_warned`` like every
        other cause."""
        interval = CONFIG.stall_detector_interval_s
        if interval <= 0:
            return []
        now = time.time()
        out: List[dict] = []
        coll_half = CONFIG.collective_timeout_s / 2.0
        coll_candidates: List[tuple] = []
        with self._lock:
            if now - self._stall_last_sweep < interval:
                return []
            self._stall_last_sweep = now
            latest: Dict[TaskID, TaskEvent] = {}
            for ev in self.task_events:
                latest[ev.task_id] = ev
            # entries for tasks evicted from the ring must not leak
            for tid in [t for t in self._stall_warned if t not in latest]:
                del self._stall_warned[tid]
            total: Dict[str, float] = {}
            avail: Dict[str, float] = {}
            for n in self.nodes.values():
                if not n.alive:
                    continue
                for k, v in n.resources_total.items():
                    total[k] = total.get(k, 0.0) + v
                for k, v in (n.resources_available or {}).items():
                    avail[k] = avail.get(k, 0.0) + v
            n_pending = sum(1 for ev in latest.values()
                            if ev.state in self._STALL_PENDING_STATES)
            for tid, ev in latest.items():
                if ev.state in self._STALL_PENDING_STATES:
                    threshold = CONFIG.stall_pending_threshold_s
                elif ev.state == "RUNNING":
                    threshold = CONFIG.stall_running_threshold_s
                    age = now - ev.timestamp
                    if (coll_probe is not None and coll_half > 0
                            and age >= coll_half
                            and self._stall_warned.get(tid)
                            != "collective_stuck"):
                        # a collective wedges long before the generic
                        # RUNNING threshold (300s default vs timeout/2)
                        coll_candidates.append((ev, age))
                else:
                    self._stall_warned.pop(tid, None)
                    continue
                age = now - ev.timestamp
                if threshold <= 0 or age < threshold:
                    continue
                cause, message = self._diagnose_stall_locked(
                    ev, total, avail, n_pending, age, latest)
                if (cause == "slow_running" and self._stall_warned.get(
                        tid) == "collective_stuck"):
                    # collective_stuck is the more specific refinement
                    # of slow_running — don't flip-flop between them
                    continue
                if self._stall_warned.get(tid) == cause:
                    continue
                self._stall_warned[tid] = cause
                out.append({"message": message,
                            "task_id": tid.hex(),
                            "task_name": ev.name,
                            "task_state": ev.state,
                            "age_s": round(age, 1),
                            "cause": cause})
        if coll_candidates and coll_probe is not None:
            try:
                probed = coll_probe(coll_candidates) or []
            except Exception:   # noqa: BLE001 — diagnosis is best-effort
                probed = []
            for ev, cause, message in probed:
                with self._lock:
                    if self._stall_warned.get(ev.task_id) == cause:
                        continue
                    self._stall_warned[ev.task_id] = cause
                out.append({"message": message,
                            "task_id": ev.task_id.hex(),
                            "task_name": ev.name,
                            "task_state": ev.state,
                            "age_s": round(now - ev.timestamp, 1),
                            "cause": cause})
        return out

    def _diagnose_stall_locked(self, ev: TaskEvent, total: dict,
                               avail: dict, n_pending: int, age: float,
                               latest: Dict[TaskID, TaskEvent],
                               ) -> Tuple[str, str]:
        """Order matters: the most specific verifiable cause wins."""
        missing = [oid for oid in (ev.pending_args or ())
                   if oid not in self.directory]
        if missing:
            # an object whose producing task is still live is upstream
            # slowness, not loss — only claim "never created"/"lost"
            # when NO live producer exists for any missing dep
            for oid in missing:
                spec = self.lineage.get(oid)
                pev = latest.get(spec.task_id) if spec is not None else None
                if pev is not None and pev.state not in ("FINISHED",
                                                         "FAILED"):
                    return ("slow_producer",
                            f"task {ev.name!r} has waited {age:.0f}s for "
                            f"object {oid.hex()[:12]} still being "
                            f"produced by task {spec.name!r} "
                            f"({pev.state}) — upstream slowness, not "
                            "loss")
            never = [o for o in missing if o not in self._sealed_once]
            what = "never created" if never else "lost"
            oids = ", ".join(o.hex()[:12] for o in missing[:4])
            recon = ("" if any(o in self.lineage for o in missing)
                     else " and cannot be reconstructed (no lineage)")
            return ("blocked_object",
                    f"task {ev.name!r} has waited {age:.0f}s for "
                    f"object(s) {oids} that were {what}{recon}")
        res = ev.resources or {}
        if res:
            # per-NODE feasibility, not the summed cluster total: a
            # {CPU: 3} task on two 2-CPU nodes fits the sum but no node,
            # and will never schedule (matches scheduler.pick_node)
            alive = [n for n in self.nodes.values() if n.alive]
            fits_some = any(
                all(n.resources_total.get(k, 0.0) >= v
                    for k, v in res.items())
                for n in alive)
            if not fits_some:
                biggest = {k: max((n.resources_total.get(k, 0.0)
                                   for n in alive), default=0.0)
                           for k in res}
                return ("unsatisfiable_resources",
                        f"task {ev.name!r} demands {res} but no single "
                        f"node can satisfy it (largest per-resource "
                        f"capacities {biggest}, cluster total "
                        f"{ {k: total.get(k, 0.0) for k in res} }) — it "
                        "will never schedule")
        if ev.is_actor_task and ev.actor_id is not None:
            rec = self.actors.get(ev.actor_id)
            if rec is not None and rec.state == ACTOR_DEAD:
                reason = rec.death_reason or "no reason recorded"
                return ("actor_dead",
                        f"call {ev.name!r} targets dead actor "
                        f"{ev.actor_id.hex()[:12]} ({reason})")
        if ev.state == "RUNNING":
            return ("slow_running",
                    f"task {ev.name!r} has been RUNNING for {age:.0f}s "
                    "— inspect worker stacks with `rtpu stack` or "
                    "`rtpu profile`")
        return ("queue_saturation",
                f"task {ev.name!r} has been queued {age:.0f}s; its shape "
                f"fits the cluster but capacity hasn't freed (available "
                f"{avail}, {n_pending} task(s) pending) — queue "
                "saturation")

    # ------------------------------------------------------------- events
    def record_task_event(self, ev: TaskEvent) -> None:
        with self._lock:
            self.task_events.append(ev)

    def list_task_events(self, limit: int = 1000) -> List[TaskEvent]:
        with self._lock:
            return list(self.task_events)[-limit:]

    # --------------------------------------- structured events + spans
    def record_cluster_event(self, rec: dict) -> None:
        with self._lock:
            evicted = (self.cluster_events.maxlen is not None
                       and len(self.cluster_events)
                       == self.cluster_events.maxlen)
            if evicted:
                self._events_evicted += 1
            self.cluster_events.append(rec)
        if evicted:
            # outside the plane lock (counter_inc takes a telemetry
            # shard lock): silent ring loss is itself observable
            telemetry.counter_inc(M_EVENTS_EVICTED)

    def list_cluster_events(self, limit: int = 1000,
                            since: Optional[float] = None,
                            until: Optional[float] = None) -> List[dict]:
        with self._lock:
            rows = list(self.cluster_events)
        if since is not None:
            rows = [r for r in rows if (r.get("timestamp") or 0) >= since]
        if until is not None:
            rows = [r for r in rows if (r.get("timestamp") or 0) <= until]
        return rows[-limit:]

    def events_stats(self) -> dict:
        with self._lock:
            return {"buffered": len(self.cluster_events),
                    "capacity": self.cluster_events.maxlen,
                    "evicted": self._events_evicted}

    # -------------------------------------------- lifecycle transitions
    # concurrency: requires(gcs.plane)
    def _record_lifecycle_locked(self, kind: str, ident: str, state: str,
                                 **fields) -> None:
        rec = {"kind": kind, "id": ident, "state": state,
               "ts": time.time()}
        rec.update({k: v for k, v in fields.items() if v is not None})
        self.lifecycle_events.append(rec)

    def lifecycle_snapshot(self, limit: int = 10000,
                           since: Optional[float] = None) -> List[dict]:
        """Node/actor/PG state transitions, retained past death."""
        with self._lock:
            rows = list(self.lifecycle_events)
        if since is not None:
            rows = [r for r in rows if r["ts"] >= since]
        return rows[-limit:]

    def record_spans(self, spans: List[dict]) -> None:
        with self._lock:
            self.spans.extend(spans)

    def list_spans(self, limit: int = 10000) -> List[dict]:
        with self._lock:
            return list(self.spans)[-limit:]

    # ------------------------------------------------------------ metrics
    # concurrency: requires(gcs.plane)
    def _metric_series_ok(self, table: dict, key: tuple) -> bool:
        """Series-cardinality cap: a runaway tag (e.g. a per-request id)
        must not grow the head without bound."""
        if key in table:
            return True
        if (len(self.metrics_counters) + len(self.metrics_gauges)
                + len(self.metrics_hists)
                + len(self.metrics_digests)) >= CONFIG.metric_series_limit:
            self._metrics_dropped_keys.add(key)
            return False
        return True

    def record_metrics(self, payload: dict) -> None:
        """Merge one process's telemetry deltas (counters += delta,
        gauges latest-timestamp-wins, histogram buckets elementwise)."""
        with self._lock:
            for name, m in (payload.get("meta") or {}).items():
                existing = self.metrics_meta.get(name)
                if existing is None:
                    self.metrics_meta[name] = dict(m)
                elif m.get("description") and not existing.get("description"):
                    existing["description"] = m["description"]
            for key, delta in (payload.get("counters") or {}).items():
                if self._metric_series_ok(self.metrics_counters, key):
                    self.metrics_counters[key] = (
                        self.metrics_counters.get(key, 0.0) + delta)
            for key, vt in (payload.get("gauges") or {}).items():
                if vt[0] != vt[0]:
                    # NaN delete marker (telemetry.gauge_delete): the
                    # series' subject is gone — forget the series
                    # instead of exporting the marker, and tombstone
                    # the key so an older in-flight publish can't
                    # re-insert it
                    self.metrics_gauges.pop(key, None)
                    self._gauge_tombstones[key] = max(
                        vt[1], self._gauge_tombstones.get(key, 0.0))
                    if len(self._gauge_tombstones) > 1024:
                        for k in sorted(self._gauge_tombstones,
                                        key=self._gauge_tombstones.get
                                        )[:512]:
                            del self._gauge_tombstones[k]
                    continue
                dead_ts = self._gauge_tombstones.get(key)
                if dead_ts is not None:
                    if vt[1] <= dead_ts:
                        continue            # straggler from a retiree
                    del self._gauge_tombstones[key]   # re-created
                if not self._metric_series_ok(self.metrics_gauges, key):
                    continue
                old = self.metrics_gauges.get(key)
                if old is None or vt[1] >= old[1]:
                    self.metrics_gauges[key] = tuple(vt)
            for key, h in (payload.get("hists") or {}).items():
                if not self._metric_series_ok(self.metrics_hists, key):
                    continue
                cur = self.metrics_hists.get(key)
                if cur is None:
                    self.metrics_hists[key] = {
                        "buckets": tuple(h["buckets"]),
                        "counts": list(h["counts"]),
                        "sum": float(h["sum"]), "count": int(h["count"]),
                        "exemplar": h.get("exemplar")}
                elif cur["buckets"] == tuple(h["buckets"]):
                    cur["counts"] = [a + b for a, b in
                                     zip(cur["counts"], h["counts"])]
                    cur["sum"] += h["sum"]
                    cur["count"] += h["count"]
                    if h.get("exemplar") is not None:
                        cur["exemplar"] = h["exemplar"]
                else:
                    # same name+tags, different boundaries: buckets can't
                    # merge — keep the first layout, fold into sum/count
                    # so totals stay right, and count the conflict
                    cur["sum"] += h["sum"]
                    cur["count"] += h["count"]
                    cur["counts"][-1] += int(h["count"])
                    self._metrics_conflict_keys.add(key)
            for key, d in (payload.get("digests") or {}).items():
                if self._metric_series_ok(self.metrics_digests, key):
                    self.metrics_digests[key] = \
                        telemetry.merge_digest_payloads(
                            self.metrics_digests.get(key), d)
                    if (self.metrics_history.enabled
                            and CONFIG.metrics_history_capacity > 0):
                        # interval accumulator for the history plane: a
                        # frame's quantiles cover the frame's WINDOW
                        # (cumulative digests can't be subtracted)
                        cur = self._history_interval_digests.get(key)
                        self._history_interval_digests[key] = (
                            telemetry.merge_digest_payloads(cur, d)
                            if cur else dict(d))

    def record_history_snapshot(self) -> Optional[int]:
        """One metrics-history tick (triggered from the plane-hosting
        node's tick loop, self-rate-limited to the finest level step
        like the stall/leak sweeps): append the merge table's current
        values plus the accumulated interval digests as a frame.
        Returns the ring's estimated byte total, or ``None`` when
        rate-limited/disabled."""
        # the live CONFIG check (beside the ring's init-time flag) lets
        # an A/B toggle retention off in-process (bench_telemetry's
        # history_ab gate measures exactly this knob)
        if not (self.metrics_history.enabled
                and CONFIG.metrics_history_capacity > 0):
            return None
        now = time.time()
        with self._lock:
            finest = self.metrics_history.levels[0].step
            if now - self._history_last < finest:
                return None
            self._history_last = now
            counters = dict(self.metrics_counters)
            gauges = {k: v[0] for k, v in self.metrics_gauges.items()}
            hists = {k: (h["count"], h["sum"])
                     for k, h in self.metrics_hists.items()}
            interval = self._history_interval_digests
            self._history_interval_digests = {}
            return self.metrics_history.record(now, counters, gauges,
                                               hists, interval)

    def metrics_history_query(self, name: Optional[str] = None,
                              tags: Optional[dict] = None,
                              window: Optional[float] = None,
                              step: Optional[float] = None) -> dict:
        """Windowed aligned series from the retention ring (the
        ``state.metrics_history()`` backend). The plane lock covers only
        the cheap frame-ref snapshot; conversion/filtering of hundreds
        of frames runs OUTSIDE it (frames are immutable once appended),
        so doctor/dashboard/trend queries never stall scheduling."""
        with self._lock:
            snap = self.metrics_history.level_snapshot()
            enabled = self.metrics_history.enabled
        return history_mod.query_levels(snap, enabled, name=name,
                                        tags=tags, window=window,
                                        step=step)

    def metrics_history_dump(self) -> dict:
        """Whole-ring dump for debug bundles (offline replay); same
        snapshot-then-convert-unlocked shape as the query path."""
        with self._lock:
            snap = self.metrics_history.level_snapshot()
            enabled = self.metrics_history.enabled
            total = self.metrics_history.total_bytes
            evicted = self.metrics_history.frames_evicted
        return history_mod.dump_levels(snap, enabled, total, evicted)

    def metrics_snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.metrics_counters),
                "gauges": dict(self.metrics_gauges),
                "hists": {k: {**v, "counts": list(v["counts"])}
                          for k, v in self.metrics_hists.items()},
                "digests": {k: dict(v)
                            for k, v in self.metrics_digests.items()},
                "meta": {k: dict(v) for k, v in self.metrics_meta.items()},
                "dropped_series": (len(self._metrics_dropped_keys)
                                   + len(self._metrics_conflict_keys)),
            }

    # ------------------------------------------------------------- pubsub
    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> None:
        """In-process pubsub (reference analogue: ``src/ray/pubsub/`` long-poll
        channels). Callbacks run on the publisher's thread; keep them cheap."""
        with self._lock:
            self._subscribers.setdefault(channel, []).append(callback)

    def publish(self, channel: str, payload: Any) -> None:
        with self._lock:
            subs = list(self._subscribers.get(channel, ()))
        for cb in subs:
            try:
                cb(payload)
            except Exception:
                pass
