"""Lock registry + opt-in runtime lock-order sanitizer.

Every lock the runtime constructs goes through the factories here
(``lock()`` / ``rlock()`` / ``condition()``) under a **declared name**
from ``REGISTRY`` — the single Python source of truth for the lock
hierarchy documented in DESIGN.md ("Threading model & lock hierarchy")
and enforced statically by ``scripts/check_concurrency.py``. Reference
analogue: the TSan/deadlock annotations the C++ core wires into CI
(``src/ray/util/mutex_protected.h`` + sanitizer builds); a Python
runtime gets the same class of coverage from this module plus the AST
analyzer.

Normally (``RTPU_LOCKSAN`` unset/0) the factories return plain
``threading`` primitives — zero overhead beyond one function call at
construction. With ``RTPU_LOCKSAN=1`` (tier-1 sets this in conftest)
every lock is wrapped by ``_SanLock``, which on each **blocking**
acquire:

- checks the acquisition against the declared hierarchy: while holding
  a registered lock of level L, only strictly-greater levels may be
  acquired (re-entry of the same ``rlock`` object is exempt; re-entry
  of a plain ``lock`` is reported as a guaranteed self-deadlock);
- records the (held → acquired) edge in a process-wide acquisition-
  order graph and searches it for a cycle **before** blocking, so an
  A→B / B→A inversion across two threads is reported (and in ``raise``
  mode, refused) at the second thread's acquire — before the threads
  wedge;
- keeps the acquisition stack of every first-seen edge so a violation
  report shows both sides of the inversion.

Try-locks and timed acquires only update held-state (they cannot
deadlock by themselves and the transport's opportunistic-drainer
try-lock pattern must stay silent). Violations go to
``violations()`` and stderr (``RTPU_LOCKSAN_MODE=log``, the default)
or raise ``LockOrderViolation`` at the acquire site
(``RTPU_LOCKSAN_MODE=raise`` or ``set_mode("raise")``).

Unregistered names (tests, scratch locks) are allowed at runtime: they
skip the hierarchy check but fully participate in cycle detection. The
static analyzer is what rejects unregistered names *inside* ray_tpu/.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
from typing import Dict, List, Optional

__all__ = [
    "REGISTRY", "lock", "rlock", "condition", "enabled", "set_mode",
    "violations", "clear_violations", "LockOrderViolation",
]

# --------------------------------------------------------------- registry
#
# name -> (module, kind, level, what it protects).
#
# Levels define the global acquisition order: a thread holding a lock of
# level L may only block-acquire strictly greater levels. Independent
# leaf locks (never co-held with anything) still get distinct levels so
# a future nesting forces a conscious ordering decision instead of
# silently passing. The DESIGN.md table and this dict are cross-checked
# by check_concurrency.py (both directions), as are the construction
# sites.

REGISTRY: Dict[str, tuple] = {
    # --- client submission/refcount plane (outermost: held across sends
    # --- by design, see the flush_refs/flush_submissions FIFO comments)
    "client.edge_flush": ("_private/client.py", "lock", 10,
                          "ref-edge batch FIFO: held across take-and-send"),
    "client.sub": ("_private/client.py", "lock", 12,
                   "submission buffer; held across the batch send (FIFO)"),
    "client.ref": ("_private/client.py", "lock", 14,
                   "local per-object refcounts + edge buffer"),
    "client.gen_credit": ("_private/client.py", "lock", 16,
                          "streaming-generator producer credit table"),
    # --- control plane
    "gcs.plane": ("_private/gcs.py", "rlock", 20,
                  "every GlobalControlPlane registry/table"),
    "gcs.journal": ("_private/gcs_storage.py", "lock", 25,
                    "journal file handle (append/compact/close)"),
    # --- node service (cross-thread state next to the dispatcher)
    "node.res": ("_private/node.py", "lock", 30,
                 "resources_available + PG reservations + GPU slots"),
    "node.debug": ("_private/node.py", "lock", 32,
                   "in-flight debug-collection futures/tokens"),
    "gcs_server.conns": ("_private/gcs_service.py", "lock", 34,
                         "GcsServer conn/subscription tables"),
    "gcs_client.subs": ("_private/gcs_service.py", "lock", 36,
                        "RemoteControlPlane subscriber lists"),
    # --- object plane
    "store.entries": ("_private/object_store.py", "rlock", 38,
                      "store entry table, budget, arena quarantine"),
    "store.reader_segments": ("_private/object_store.py", "lock", 40,
                              "per-process attached-segment cache"),
    # --- collective data plane
    "coll.mailbox": ("_private/coll_transport.py", "condition", 42,
                     "per-process chunk mailbox; condvar wakes waiters"),
    "coll.recorder": ("_private/flight_recorder.py", "lock", 43,
                      "flight-recorder group/op tables (ring appends "
                      "are lock-free; this guards begin/end/snapshot)"),
    # --- independent leaves (never co-held today; distinct levels so a
    # --- future nesting trips the sanitizer instead of passing silently)
    "events.file": ("_private/events.py", "lock", 44,
                    "events JSONL append serialization"),
    "debug.bundle": ("_private/debug_bundle.py", "lock", 45,
                     "auto-capture once-per-reason set"),
    "jobs.manager": ("job/manager.py", "lock", 46,
                     "job records + supervisor proc table"),
    "serve.controller": ("serve/controller.py", "lock", 48,
                         "deployment target/replica state"),
    "serve.handle": ("serve/handle.py", "lock", 50,
                     "per-handle replica list + in-flight counters"),
    "serve.batcher": ("serve/batching.py", "lock", 52,
                      "batcher thread liveness"),
    "serve.multiplex": ("serve/multiplex.py", "lock", 54,
                        "per-replica model LRU"),
    "serve.replica_depth": ("serve/replica.py", "lock", 56,
                            "replica queue-depth counter"),
    "collective.groups": ("comm/collective.py", "lock", 58,
                          "per-process collective group registry"),
    "workflow.registry": ("workflow/__init__.py", "lock", 60,
                          "workflow storage create/resume exclusion"),
    "autoscaler.provider": ("autoscaler/node_provider.py", "lock", 62,
                            "fake provider node list"),
    "api.remote_fn": ("api.py", "lock", 64,
                      "lazy function blob export"),
    "api.actor_class": ("api.py", "lock", 66,
                        "lazy actor class blob export"),
    "api.actor_seq": ("api.py", "lock", 68,
                      "per-handle actor call sequence numbers"),
    "tracing.buffer": ("util/tracing.py", "lock", 70,
                       "finished-span buffer"),
    "tqdm.render": ("util/tqdm_ray.py", "lock", 72,
                    "driver-side progress render state"),
    "native.arena_cache": ("_private/native.py", "lock", 74,
                           "per-process ArenaReader cache"),
    "native.lib": ("_private/native.py", "lock", 76,
                   "one-time native library build/load"),
    "ext.build": ("ops/_ext.py", "lock", 78,
                  "one-time CUDA kernel build/load"),
    # --- transport (innermost of the send path; the drainer protocol
    # --- holds conn.flush while failing futures through on_send_error)
    "conn.flush": ("_private/protocol.py", "lock", 85,
                   "active-drainer exclusion (held across sendmsg)"),
    "rpc.futures": ("_private/rpc.py", "lock", 87,
                    "RpcChannel req-id -> future table"),
    "client.req": ("_private/client.py", "lock", 88,
                   "CoreClient req-id -> future table"),
    "conn.queue": ("_private/protocol.py", "lock", 90,
                   "per-connection send queue + broken/closing flags"),
    # --- telemetry (innermost everywhere: record calls happen under
    # --- arbitrary runtime locks)
    "telemetry.meta": ("_private/telemetry.py", "lock", 93,
                       "metric metadata registry"),
    "telemetry.runtime": ("_private/telemetry.py", "lock", 94,
                          "flusher/sampler lifecycle + node registry"),
    "telemetry.shard": ("_private/telemetry.py", "lock", 95,
                        "one metrics shard (8 instances)"),
}

# ----------------------------------------------------------- guarded-by
#
# FIELDS: declared shared-state ownership — which guard protects each
# multi-thread-touched attribute (the data-side complement of REGISTRY,
# reference: Clang GUARDED_BY annotations across src/ray/common/).
# Key: "<module short name>.<Class>.<attr>" for instance fields,
# "<module short name>.<name>" for module-level state. Value:
#
#   "<lock name>"        guarded by that REGISTRY lock (reads+writes
#                        pair-checked at runtime; every lexical write
#                        must sit under `with <lock>` or a
#                        `# concurrency: requires(<lock>)` function —
#                        rule (h) of scripts/check_concurrency.py)
#   "thread:<pat>"       write-confined to threads whose name contains
#                        <pat>; cross-thread reads are tolerated dirty
#                        reads (GIL-atomic), a foreign write is a
#                        violation
#   "<lock name>|static" guarded by that lock, verified by the STATIC
#                        pass only — the documented hot-path exemption
#                        (per-message transport innards, metric shards)
#                        where a per-access runtime hook costs more
#                        than the residual risk of the small audited
#                        module it guards
#   "atomic:<reason>"    deliberately lock-free shared state relying on
#                        GIL-atomic single ops; declared so the
#                        undeclared-candidate inference can't rot, not
#                        instrumented
#
# Runtime checking lives in _private/fieldsan.py (RTPU_FIELDSAN=1, on
# in tier-1); classes/modules opt in with @fieldsan.guarded /
# fieldsan.instrument_module, which rule (h) verifies. DESIGN.md
# "Shared-state ownership map" mirrors this table (cross-checked both
# directions).

FIELDS: Dict[str, str] = {
    # --- control plane: every registry/table under the one plane lock
    "gcs.GlobalControlPlane.nodes": "gcs.plane",
    "gcs.GlobalControlPlane.actors": "gcs.plane",
    "gcs.GlobalControlPlane.named_actors": "gcs.plane",
    "gcs.GlobalControlPlane.jobs": "gcs.plane",
    "gcs.GlobalControlPlane.kv": "gcs.plane",
    "gcs.GlobalControlPlane.placement_groups": "gcs.plane",
    "gcs.GlobalControlPlane.directory": "gcs.plane",
    "gcs.GlobalControlPlane.gen_streams": "gcs.plane",
    "gcs.GlobalControlPlane.pending_pgs": "gcs.plane",
    "gcs.GlobalControlPlane.task_events": "gcs.plane",
    "gcs.GlobalControlPlane.cluster_events": "gcs.plane",
    "gcs.GlobalControlPlane.lifecycle_events": "gcs.plane",
    "gcs.GlobalControlPlane._events_evicted": "gcs.plane",
    "gcs.GlobalControlPlane._history_interval_digests": "gcs.plane",
    "gcs.GlobalControlPlane._history_last": "gcs.plane",
    "gcs.GlobalControlPlane.spans": "gcs.plane",
    "gcs.GlobalControlPlane.metrics_counters": "gcs.plane",
    "gcs.GlobalControlPlane.metrics_gauges": "gcs.plane",
    "gcs.GlobalControlPlane._gauge_tombstones": "gcs.plane",
    "gcs.GlobalControlPlane.metrics_hists": "gcs.plane",
    "gcs.GlobalControlPlane.metrics_digests": "gcs.plane",
    "gcs.GlobalControlPlane.metrics_meta": "gcs.plane",
    "gcs.GlobalControlPlane._metrics_dropped_keys": "gcs.plane",
    "gcs.GlobalControlPlane._metrics_conflict_keys": "gcs.plane",
    "gcs.GlobalControlPlane._subscribers": "gcs.plane",
    "gcs.GlobalControlPlane.ref_holders": "gcs.plane",
    "gcs.GlobalControlPlane.ref_pins": "gcs.plane",
    "gcs.GlobalControlPlane._task_arg_refs": "gcs.plane",
    "gcs.GlobalControlPlane._task_pin_owner": "gcs.plane",
    "gcs.GlobalControlPlane._freed_early": "gcs.plane",
    "gcs.GlobalControlPlane._contained_pins": "gcs.plane",
    "gcs.GlobalControlPlane._contained_pending": "gcs.plane",
    "gcs.GlobalControlPlane._zero_pending": "gcs.plane",
    "gcs.GlobalControlPlane.lineage": "gcs.plane",
    "gcs.GlobalControlPlane._lineage_live": "gcs.plane",
    "gcs.GlobalControlPlane._lineage_bytes": "gcs.plane",
    "gcs.GlobalControlPlane._sealed_once": "gcs.plane",
    "gcs.GlobalControlPlane._reconstruct_claims": "gcs.plane",
    "gcs.GlobalControlPlane._reconstruct_counts": "gcs.plane",
    "gcs.GlobalControlPlane.actor_checkpoints": "gcs.plane",
    "gcs.GlobalControlPlane._actor_reroutes": "gcs.plane",
    "gcs.GlobalControlPlane._stall_last_sweep": "gcs.plane",
    "gcs.GlobalControlPlane._stall_warned": "gcs.plane",
    "gcs.GlobalControlPlane.obj_provenance": "gcs.plane",
    "gcs.GlobalControlPlane._leaks": "gcs.plane",
    "gcs.GlobalControlPlane._pinned_zero_since": "gcs.plane",
    "gcs.GlobalControlPlane._leak_warned": "gcs.plane",
    "gcs.GlobalControlPlane._leak_last_sweep": "gcs.plane",
    "gcs.GlobalControlPlane._storage": "gcs.plane",
    # --- metrics-history rings: owned by the plane, serialized under
    # --- its lock (standalone instances in unit tests are
    # --- single-threaded; the live plane routes queries through
    # --- gcs.metrics_history_query)
    "history.MetricsHistory.levels": "gcs.plane",
    "history.MetricsHistory.total_bytes": "gcs.plane",
    "history.MetricsHistory.frames_evicted": "gcs.plane",
    "history._Level.frames": "gcs.plane",
    "history._Level.last_ts": "gcs.plane",
    "history._Level.pending_digests": "gcs.plane",
    # --- per-process client (CoreClient)
    "client.CoreClient._futures": "client.req",
    "client.CoreClient._next_req": "client.req",
    "client.CoreClient._ref_counts": "client.ref|static",
    "client.CoreClient._edge_buf": "client.ref|static",
    "client.CoreClient._prov_buf": "client.ref|static",
    "client.CoreClient._sub_buf": "client.sub|static",
    "client.CoreClient._gen_credit": "client.gen_credit",
    "client.CoreClient._pending_decrs":
        "atomic:GC-safe lock-free deque — ObjectRef.__del__ may run "
        "while this thread already holds client.ref",
    "client.CoreClient._registered_fns":
        "atomic:set add/membership are GIL-atomic; a duplicate "
        "registration is an idempotent KV_PUT",
    # --- node service: ONE dispatcher thread owns the scheduling state
    "node.NodeService._pending": "thread:rtpu-dispatch",
    "node._PendingQueue._by_shape": "thread:rtpu-dispatch",
    "node.NodeService._workers": "thread:rtpu-dispatch",
    "node.NodeService._idle": "thread:rtpu-dispatch",
    "node.NodeService._num_starting": "thread:rtpu-dispatch",
    "node.NodeService._env_spawn_failures": "thread:rtpu-dispatch",
    "node.NodeService._env_spawn_error": "thread:rtpu-dispatch",
    "node.NodeService._exec_outbox": "thread:rtpu-dispatch",
    "node.NodeService._reply_outbox": "thread:rtpu-dispatch",
    "node.NodeService._in_batch": "thread:rtpu-dispatch",
    "node.NodeService._route_debits": "thread:rtpu-dispatch",
    "node.NodeService._node_versions": "thread:rtpu-dispatch",
    "node.NodeService._task_origin": "thread:rtpu-dispatch",
    "node.NodeService._waiting_deps": "thread:rtpu-dispatch",
    "node.NodeService._dep_index": "thread:rtpu-dispatch",
    "node.NodeService._running": "thread:rtpu-dispatch",
    "node.NodeService._owned": "thread:rtpu-dispatch",
    "node.NodeService._actors": "thread:rtpu-dispatch",
    "node.NodeService._actor_queues": "thread:rtpu-dispatch",
    "node.NodeService._actor_blocked_owners": "thread:rtpu-dispatch",
    "node.NodeService._get_waiters": "thread:rtpu-dispatch",
    "node.NodeService._wait_waiters": "thread:rtpu-dispatch",
    "node.NodeService._gen_waiters": "thread:rtpu-dispatch",
    "node.NodeService._gen_consumed_cache": "thread:rtpu-dispatch",
    "node.NodeService._gen_local": "thread:rtpu-dispatch",
    "node.NodeService._obj_waiter_index": "thread:rtpu-dispatch",
    "node.NodeService._next_waiter": "thread:rtpu-dispatch",
    "node.NodeService._infeasible": "thread:rtpu-dispatch",
    "node.NodeService._repark_deadline": "thread:rtpu-dispatch",
    "node.NodeService._conn_refs": "thread:rtpu-dispatch",
    "node.NodeService._reconstructing": "thread:rtpu-dispatch",
    "node.NodeService._reroute_parked": "thread:rtpu-dispatch",
    "node.NodeService._conn_kind": "thread:rtpu-dispatch",
    "node.NodeService._conn_worker": "thread:rtpu-dispatch",
    "node.NodeService._conn_coll_wid": "thread:rtpu-dispatch",
    "node.NodeService._coll_conns": "thread:rtpu-dispatch",
    "node.NodeService._driver_conn_keys": "thread:rtpu-dispatch",
    # tick-thread-confined heartbeat state
    "node.NodeService._last_hb_at": "thread:rtpu-tick",
    "node.NodeService._hb_count": "thread:rtpu-tick",
    "node.NodeService._resource_version": "thread:rtpu-tick",
    "node.NodeService._last_hb_snapshot": "thread:rtpu-tick",
    "node.NodeService._last_hb_pending": "thread:rtpu-tick",
    # resource accounting under node.res
    "node.NodeService.resources_available": "node.res",
    "node.NodeService.pg_reservations": "node.res",
    "node.NodeService.pg_bundle_total": "node.res",
    "node.NodeService._gpu_free": "node.res",
    # debug-collection futures under node.debug
    "node.NodeService._debug_futures": "node.debug",
    "node.NodeService._next_debug_token": "node.debug",
    # deliberately lock-free node state
    "node.NodeService._conns":
        "atomic:unique-key inserts from the two accept threads, pops "
        "on the dispatcher; dict ops are GIL-atomic",
    "node.NodeService._coll_peers":
        "atomic:idempotent same-value cache fill from reader threads "
        "(chunk forwarding must not pay a lock per chunk)",
    "node.NodeService._peers":
        "atomic:idempotent cache fill; readers revalidate via each "
        "peer's closed/dead flag",
    "node.NodeService._coll_health_cache":
        "atomic:racy TTL cache — a tuple swap; duplicate diagnosis "
        "fan-outs are the only cost of a lost race",
    # --- worker runtime: exec-thread-confined actor state; the rest is
    # --- deliberately lock-free reader<->exec signalling
    "worker.WorkerRuntime._actor_instance": "thread:task-exec",
    "worker.WorkerRuntime._actor_spec": "thread:task-exec",
    "worker.WorkerRuntime._pool": "thread:task-exec",
    "worker.WorkerRuntime._aio_loop": "thread:task-exec",
    "worker.WorkerRuntime._current_task_thread": "thread:task-exec",
    "worker.WorkerRuntime._functions":
        "atomic:idempotent cache fill; concurrent actor pool threads "
        "may each load the same function blob once",
    "worker.WorkerRuntime._cancelled_queued":
        "atomic:reader thread adds, exec thread discards; set ops are "
        "GIL-atomic and a missed cancel re-runs the cancel path",
    "worker.WorkerRuntime._blocked_in_get":
        "atomic:bool flag written by the exec thread, read by the "
        "reader's bounce check — a stale read only delays one bounce",
    "worker.WorkerRuntime._ckpt_counter":
        "atomic:itertools.count allocation is GIL-atomic; overlapping "
        "re-seeds are benign (documented in checkpoint_now)",
    "worker.WorkerRuntime._ckpt_calls":
        "atomic:periodic-trigger counter; a lost increment delays one "
        "checkpoint by one call",
    "worker.WorkerRuntime._ckpt_last_t":
        "atomic:periodic-trigger stamp, same tolerance as _ckpt_calls",
    "worker.WorkerRuntime._kicker":
        "atomic:benign duplicate kicker if two completions race the "
        "first _ensure_kicker; both just kick the same conn",
    # --- collective chunk mailbox (module-level, under coll.mailbox)
    "coll_transport._slots": "coll.mailbox",
    "coll_transport._born": "coll.mailbox",
    "coll_transport._fenced": "coll.mailbox",
    "coll_transport._next_sweep": "coll.mailbox",
    "coll_transport._stats":
        "atomic:per-field single-writer counters (rank thread / reader "
        "thread); dict slot += is the documented tolerance",
    # --- telemetry shards + runtime registry
    "telemetry._Digest.cents":
        "atomic:a digest instance is owned by its containing table's "
        "lock (telemetry.shard live, gcs.plane on the merge path); "
        "never shared across owners",
    "telemetry._Digest.buf": "atomic:see telemetry._Digest.cents",
    "telemetry._Digest.count": "atomic:see telemetry._Digest.cents",
    "telemetry._Digest.sum": "atomic:see telemetry._Digest.cents",
    "telemetry._Digest.min": "atomic:see telemetry._Digest.cents",
    "telemetry._Digest.max": "atomic:see telemetry._Digest.cents",
    "telemetry._Shard.counters": "telemetry.shard|static",
    "telemetry._Shard.gauges": "telemetry.shard|static",
    "telemetry._Shard.gauges_dirty": "telemetry.shard|static",
    "telemetry._Shard.hists": "telemetry.shard|static",
    "telemetry._Shard.digests": "telemetry.shard|static",
    "telemetry._meta": "telemetry.meta",
    "telemetry._conflict_warned": "telemetry.meta",
    "telemetry._nodes": "telemetry.runtime",
    "telemetry._flusher_started":
        "atomic:double-checked flag — probed lock-free, set under "
        "telemetry.runtime",
    "telemetry._sampler_started":
        "atomic:set-once under telemetry.runtime, probed lock-free",
    "telemetry._last_flush":
        "atomic:rate-limiter stamp; a lost update costs one extra flush",
    "telemetry._last_digest_ship":
        "atomic:rate-limiter stamp for the digest ship cadence",
    "telemetry._digest_gen":
        "atomic:generation bump on reset(); handles re-resolve on "
        "mismatch",
    # --- object store
    "object_store.ObjectStore._entries": "store.entries|static",
    "object_store.ObjectStore._used": "store.entries|static",
    "object_store.ObjectStore._quarantine": "store.entries",
    "object_store.ObjectStore.num_spilled": "store.entries",
    "object_store.ObjectStore.num_restored": "store.entries",
    "object_store.ObjectStore.num_lazy_puts": "store.entries",
    "object_store.ObjectStore.num_materialized": "store.entries",
    "object_store.ObjectStore.spilled_bytes_total": "store.entries",
    "object_store.ObjectStore.restored_bytes_total": "store.entries",
    "object_store.ObjectStore._spill_events": "store.entries",
    "object_store.ObjectStore._manifest_f": "store.entries|static",
    "object_store.ObjectReader._segments": "store.reader_segments",
    # --- transport (protocol.Connection)
    "protocol.Connection._outq": "conn.queue|static",
    "protocol.Connection._broken": "conn.queue|static",
    "protocol.Connection._closing": "conn.queue|static",
    "protocol.Connection._recv_buf":
        "atomic:single reader per connection by construction (the "
        "owning process's one recv loop)",
    "protocol.Connection._decoded": 
        "atomic:single reader per connection by construction (decode "
        "buffer of the owning process's one recv loop)",
    "protocol.Connection._oob_scratch":
        "atomic:owned by the active drainer (conn.flush held via the "
        "explicit combining-drainer acquire, invisible to the "
        "with-block pass)",
    "protocol.Connection._stat_flushes":
        "atomic:drainer-owned flush counters, published every 64 "
        "flushes; conn.flush is held via explicit acquire",
    "protocol.Connection._stat_msgs":
        "atomic:drainer-owned, see _stat_flushes",
    "protocol.Connection._stat_bytes":
        "atomic:drainer-owned, see _stat_flushes",
    "protocol.Connection._stat_oob":
        "atomic:drainer-owned, see _stat_flushes",
}

# ------------------------------------------------------------- plumbing

# Fieldsan (RTPU_FIELDSAN) needs the held-lock bookkeeping the _SanLock
# wrappers maintain, so either sanitizer env enables the wrappers; the
# order/hierarchy checks stay coupled (they are accurate and cheap).
_ENABLED = any(
    os.environ.get(var, "").lower() in ("1", "true", "yes", "on")
    for var in ("RTPU_LOCKSAN", "RTPU_FIELDSAN"))
_MODE = os.environ.get("RTPU_LOCKSAN_MODE", "log")

_tls = threading.local()

# Acquisition-order graph over live lock *instances*:
#   id(lock) -> set of id(lock) acquired while it was held.
# _edge_stacks remembers the stack that created each first-seen edge so
# a cycle report can show both sides. _graph_lock is a RAW lock (never
# sanitized — it is the sanitizer). _seen_edges is probed without the
# lock (benign race: a duplicate probe just repeats the locked check).
_graph_lock = threading.Lock()
_edges: Dict[int, set] = {}
_edge_stacks: Dict[tuple, str] = {}
_names: Dict[int, str] = {}
_seen_edges: set = set()

_violations: List[dict] = []
_reported: set = set()


class LockOrderViolation(RuntimeError):
    """Raised at the acquire site in ``raise`` mode."""


def enabled() -> bool:
    return _ENABLED


def set_mode(mode: str) -> str:
    """``log`` (default) or ``raise``; returns the previous mode."""
    global _MODE
    prev, _MODE = _MODE, mode
    return prev


def violations() -> List[dict]:
    return list(_violations)


def clear_violations() -> None:
    _violations.clear()
    _reported.clear()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _fmt_stack(skip: int = 3, limit: int = 12) -> str:
    return "".join(traceback.format_list(
        traceback.extract_stack(limit=limit + skip)[:-skip]))


def _report(kind: str, message: str, extra: Optional[str] = None) -> None:
    rec = {"kind": kind, "message": message,
           "thread": threading.current_thread().name,
           "stack": _fmt_stack(skip=4)}
    _violations.append(rec)
    key = (kind, message)
    if key not in _reported:
        _reported.add(key)
        print(f"[locksan] {kind}: {message} "
              f"(thread {rec['thread']})\n{rec['stack']}"
              + (f"--- other side ---\n{extra}" if extra else ""),
              file=sys.stderr)
    if _MODE == "raise":
        raise LockOrderViolation(f"{kind}: {message}")


from collections import deque as _deque

_dead_ids: "_deque" = _deque()


def _drop_instance(lid: int) -> None:
    """weakref finalizer: record the dead lock for removal from the
    order graph. MUST NOT take _graph_lock — cyclic GC can run this
    finalizer on a thread that is already inside a ``with _graph_lock:``
    block (any allocation there can trigger a collection), and
    _graph_lock is not reentrant. deque.append is atomic and lock-free;
    the next sanitized acquire sweeps the backlog under the lock."""
    _dead_ids.append(lid)


def _sweep_dead_locked() -> None:
    """Drop GC'd locks from the graph; caller holds _graph_lock. (A
    dead id recycled by a new lock before the sweep could briefly
    inherit stale edges — the sweep runs on every first-seen edge, so
    the window is one novel acquisition order.)"""
    while True:
        try:
            lid = _dead_ids.popleft()
        except IndexError:
            return
        _edges.pop(lid, None)
        _names.pop(lid, None)
        for pair in [p for p in _seen_edges if lid in p]:
            _seen_edges.discard(pair)
            _edge_stacks.pop(pair, None)
        for dsts in _edges.values():
            dsts.discard(lid)


def _reachable(src: int, dst: int) -> bool:
    """DFS over the order graph; callers hold _graph_lock."""
    stack, seen = [src], set()
    while stack:
        cur = stack.pop()
        if cur == dst:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(_edges.get(cur, ()))
    return False


class _SanLock:
    """Sanitizing wrapper for Lock/RLock; acquire/release mirror the
    stdlib signatures and everything else passes through to the inner
    primitive, so it also serves as a Condition's inner lock
    (``condition()`` below) — Condition's wait/notify then release and
    re-acquire *through* the wrapper, keeping held-state exact across
    waits."""

    __slots__ = ("name", "kind", "level", "_inner", "__weakref__")

    def __init__(self, name: str, kind: str):
        self.name = name
        self.kind = kind
        reg = REGISTRY.get(name)
        self.level = reg[2] if reg is not None else None
        self._inner = (threading.RLock() if kind == "rlock"
                       else threading.Lock())
        import weakref
        weakref.finalize(self, _drop_instance, id(self))

    # ------------------------------------------------------------ checks
    def _check_blocking(self, held: list) -> None:
        if not held:
            return
        if any(h is self for h in held):
            if self.kind != "rlock":
                _report("self-deadlock",
                        f"re-acquiring non-reentrant lock {self.name!r} "
                        "already held by this thread")
            return
        distinct = {id(h): h for h in held}.values()
        for h in distinct:
            if (self.level is not None and h.level is not None
                    and h.level >= self.level):
                _report("hierarchy",
                        f"acquiring {self.name!r} (level {self.level}) "
                        f"while holding {h.name!r} (level {h.level}) — "
                        "declared order is strictly increasing levels")
        me = id(self)
        for h in distinct:
            pair = (id(h), me)
            if pair in _seen_edges:
                continue
            with _graph_lock:
                _sweep_dead_locked()
                if pair in _seen_edges:
                    continue
                _names[id(h)] = h.name
                _names[me] = self.name
                if _reachable(me, id(h)):
                    other = _edge_stacks.get((me, id(h)), "")
                    _report("order-cycle",
                            f"acquiring {self.name!r} while holding "
                            f"{h.name!r}, but the reverse order "
                            f"({self.name!r} before {h.name!r}) was "
                            "already observed — deadlock-capable "
                            "inversion", extra=other)
                _seen_edges.add(pair)
                _edges.setdefault(id(h), set()).add(me)
                _edge_stacks[pair] = _fmt_stack(skip=4)

    # ------------------------------------------------------- lock protocol
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking and (timeout is None or timeout < 0):
            self._check_blocking(_held())
        if timeout is None:
            timeout = -1
        got = self._inner.acquire(blocking, timeout)
        if got:
            _held().append(self)
            # held-NAME counts beside the instance list: fieldsan's
            # guard check is one dict probe instead of a scan (the
            # probe runs on every declared-field access)
            names = getattr(_tls, "held_names", None)
            if names is None:
                names = _tls.held_names = {}
            names[self.name] = names.get(self.name, 0) + 1
        return got

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                names = getattr(_tls, "held_names", None)
                if names is not None:
                    n = names.get(self.name, 1) - 1
                    if n <= 0:
                        names.pop(self.name, None)
                    else:
                        names[self.name] = n
                break
        self._inner.release()

    def __getattr__(self, name):
        # transparent passthrough (``locked`` on plain locks, etc.):
        # the wrapper exposes exactly the inner primitive's surface —
        # on 3.10 RLock has no ``locked``, and neither does its wrapper
        if name == "_inner":        # guard __init__-time recursion
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<SanLock {self.name!r} level={self.level}>"


# ------------------------------------------------------------- factories

def lock(name: str) -> "threading.Lock":
    """A mutex declared under ``name`` (see REGISTRY / DESIGN.md)."""
    if not _ENABLED:
        return threading.Lock()
    return _SanLock(name, "lock")


def rlock(name: str) -> "threading.RLock":
    if not _ENABLED:
        return threading.RLock()
    return _SanLock(name, "rlock")


def condition(name: str, cv_lock=None) -> "threading.Condition":
    """A condition variable declared under ``name``. Pass the lock it
    shares (``cv_lock``) when callers also take that lock directly;
    sanitized conditions must wrap a plain (non-reentrant) lock —
    Condition's default release/re-acquire protocol assumes one."""
    if not _ENABLED:
        return threading.Condition(cv_lock)
    if cv_lock is None:
        cv_lock = _SanLock(name, "lock")
    return threading.Condition(cv_lock)
