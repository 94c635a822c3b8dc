"""Compiled-in configuration table, overridable via environment variables.

Equivalent role to the reference's ``RAY_CONFIG`` table
(``src/ray/common/ray_config_def.h``, 209 tunables overridable via ``RAY_*``
env vars or a system-config JSON). Here every entry is a typed default that
can be overridden by ``RTPU_<NAME>`` in the environment or by passing
``_system_config={...}`` to ``init()``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

_ENV_PREFIX = "RTPU_"

# name -> (type, default, help)
_CONFIG_DEFS: Dict[str, tuple] = {
    # --- object store ---
    "object_store_memory_mb": (int, 2048, "shm budget for the local object store"),
    "object_store_shm_max_bytes": (int, 0,
                                   "byte-denominated override of the store/arena "
                                   "budget; 0 = object_store_memory_mb << 20"),
    "object_store_shm_threshold_bytes": (int, 100 * 1024,
                                         "values <= this stay on the in-heap inline "
                                         "path (carried in RPC frames); larger values "
                                         "land in the shm arena / a segment "
                                         "(reference: task_rpc_inlined_bytes_limit)"),
    "object_store_spill_threshold": (float, 0.8,
                                     "fraction of store memory above which coldest "
                                     "unpinned primary copies are spilled to disk"),
    "object_store_spill_dir": (str, "",
                               "directory for spilled objects (default: session dir)"),
    "object_store_lazy_put": (bool, True,
                              "head-driver puts of large values defer the shm copy "
                              "until first cross-process demand or spill pressure "
                              "(zero-copy put; the serialized views alias the "
                              "caller's buffers until promotion, so a put value "
                              "must not be mutated afterwards — same immutability "
                              "contract the reference's plasma copies enforce)"),
    "use_native_arena": (bool, True,
                         "allocate store objects from the C++ shm arena "
                         "(native/object_arena.cpp) when the library builds; "
                         "falls back to per-object segments"),
    # --- scheduler ---
    "worker_pipeline_depth": (int, 4,
                              "max tasks leased to one busy worker (running "
                              "+ queued) when more same-shape tasks are "
                              "pending than idle workers; grants/returns "
                              "carry per-worker monotonic lease seqs so "
                              "stale rescues are dropped (reference: "
                              "worker-lease reuse, direct_task_transport.h)."
                              " 1 disables pipelining"),
    "dispatcher_event_batch": (int, 128,
                               "max queued events the node dispatcher "
                               "drains per loop turn; the batch is handled "
                               "with one scheduling pass and one outbox "
                               "flush (a burst of TASK_DONEs frees N "
                               "workers, then dispatches once)"),
    "submit_batch_max_specs": (int, 200,
                               "client-side combining buffer: task/actor-"
                               "call submissions coalesce into one "
                               "SUBMIT_BATCH frame, flushed at this count "
                               "or by the next blocking op / flusher "
                               "cadence"),
    "scheduler_spread_threshold": (float, 0.5,
                                   "hybrid policy: pack below this node utilization, "
                                   "spread above (reference: scheduler_spread_threshold)"),
    "scheduler_top_k_fraction": (float, 0.2,
                                 "hybrid policy: random choice among best k nodes"),
    "scheduler_route_debit_ttl_s": (float, 2.0,
                                    "how long a routed-but-unconfirmed task's "
                                    "resources stay debited from the router's "
                                    "view of the target node (bridges heartbeat "
                                    "staleness so bursts don't pile onto one node)"),
    "ref_zero_grace_ms": (int, 50,
                          "delay between an object's refcount reaching zero "
                          "and its free, absorbing in-flight borrower "
                          "registrations (a ref passed through a queue actor "
                          "briefly reads as zero between the sender's drop "
                          "and the receiver's register)"),
    "generator_backpressure_window": (int, 16,
                                      "max unconsumed streaming-generator items "
                                      "in flight before the producer blocks "
                                      "(0 = unbounded; reference: "
                                      "_generator_backpressure_num_objects)"),
    "scheduler_spillback_delay_s": (float, 0.25,
                                    "re-route a queued task to another node with "
                                    "free capacity after it has starved locally "
                                    "this long (reference: lease spillback, "
                                    "cluster_task_manager.cc)"),
    "worker_lease_timeout_s": (float, 30.0, "lease request timeout"),
    # --- worker pool ---
    "num_prestart_workers": (int, 0, "workers to pre-start at node boot (0 = num_cpus)"),
    "idle_worker_killing_time_s": (float, 300.0, "kill idle workers after this long"),
    "worker_register_timeout_s": (float, 30.0, "worker registration handshake timeout"),
    "maximum_startup_concurrency": (int, 16, "max concurrent worker process launches"),
    "runtime_env_setup_timeout_s": (float, 600.0,
                                    "extra registration budget for workers "
                                    "building a pip env before first start "
                                    "(reference: "
                                    "runtime_env_setup_timeout_seconds)"),
    "worker_startup_max_failures": (int, 3,
                                    "consecutive startup failures per runtime env "
                                    "before pending tasks fail with "
                                    "RuntimeEnvSetupError (reference: PopWorker "
                                    "failure callback)"),
    "arena_free_quarantine_s": (float, 30.0,
                                "freed arena blocks whose object was ever read "
                                "are quarantined this long before reuse "
                                "(readers may hold zero-copy views)"),
    # --- autoscaling ---
    "infeasible_task_grace_s": (float, 0.0,
                                "park tasks/actors with no feasible node this "
                                "long (autoscaler scale-up window) instead of "
                                "failing immediately; 0 = fail fast"),
    # --- memory monitor / OOM killing ---
    "memory_monitor_refresh_ms": (int, 1000,
                                  "system-memory poll period; 0 disables the "
                                  "monitor (reference: memory_monitor.h:52)"),
    "memory_usage_threshold": (float, 0.95,
                               "used-memory fraction above which a worker is "
                               "killed (reference: "
                               "RAY_memory_usage_threshold)"),
    "task_oom_retries_default": (int, 3,
                                 "retries for tasks killed by the memory "
                                 "monitor, counted separately from "
                                 "max_retries (reference: task_oom_retries)"),
    # --- object ownership & memory introspection ---
    "object_callsite_enabled": (bool, True,
                                "record a creation callsite (file:line + "
                                "task/actor name) per put()/.remote() "
                                "return and ship it with ref "
                                "registration; powers state.memory_"
                                "summary(), `rtpu memory` attribution "
                                "and the OOM autopsy (reference: "
                                "RAY_record_ref_creation_sites). Off = "
                                "the submission hot path is exactly the "
                                "pre-provenance code"),
    "memory_leak_sweep_interval_s": (float, 10.0,
                                     "control-plane object-leak sweep "
                                     "period: flags objects whose only "
                                     "ref holders live on dead nodes, or "
                                     "that sat pinned with zero holders "
                                     "past the TTL; 0 disables"),
    "memory_leak_pinned_ttl_s": (float, 120.0,
                                 "an object with zero ref holders that "
                                 "stays pinned (task arg / contained "
                                 "pin) longer than this is flagged as a "
                                 "suspected leak by the sweep"),
    # --- health / failure ---
    "heartbeat_period_ms": (int, 1000,
                            "resource-view sync cadence: liveness pings "
                            "every period, the availability payload only "
                            "when it changed (versioned delta sync, "
                            "reference: ray_syncer.h:86)"),
    "health_check_period_ms": (int, 3000,
                               "control-plane liveness ping period "
                               "(reference: ray_config_def.h:815)"),
    "health_check_failure_threshold": (int, 5,
                                       "consecutive missed pings before a node is dead"),
    "task_max_retries_default": (int, 3, "default retries for retriable tasks"),
    "actor_max_restarts_default": (int, 0, "default actor restarts"),
    # --- task events / observability ---
    "task_events_buffer_size": (int, 10000, "ring buffer of task state events"),
    "cluster_events_buffer_size": (int, 5000,
                                   "ring buffer of structured cluster "
                                   "events (reference: event framework, "
                                   "src/ray/util/event.h)"),
    "fieldsan": (bool, False,
                 "guarded-by field sanitizer (fieldsan.py): instrument "
                 "declared shared fields (locksan.FIELDS) and report "
                 "cross-thread accesses whose write side does not hold "
                 "the declared guard. Read once at import (descriptors "
                 "install at class creation) — set in the environment, "
                 "not _system_config; tier-1 conftest sets it"),
    "fieldsan_mode": (str, "log",
                      "fieldsan violation handling: 'log' records + "
                      "prints with both stacks; 'raise' refuses the "
                      "access with FieldRaceViolation before a write "
                      "applies"),
    "fieldsan_sample": (int, 16,
                        "capture a stack on 1-in-N guard-held accesses "
                        "(unguarded accesses always capture); higher = "
                        "cheaper instrumented path, sparser 'other "
                        "side' stacks in reports"),
    "tracing_enabled": (bool, False,
                        "record spans around task submission/execution "
                        "with cross-process context propagation "
                        "(reference: ray.util.tracing)"),
    "span_buffer_size": (int, 20000, "ring buffer of finished spans"),
    "metrics_report_interval_ms": (int, 1000,
                                   "telemetry delta-flush period (the "
                                   "background flusher; task completions "
                                   "flush rate-limited, exports flush "
                                   "synchronously)"),
    "telemetry_enabled": (bool, True,
                          "record runtime metrics (in-process shards + "
                          "batched delta push; reference: the per-node "
                          "MetricsAgent pipeline). Off = every record "
                          "call returns immediately"),
    "telemetry_sample_interval_ms": (int, 2000,
                                     "per-node host/device sampler period "
                                     "(RSS, store fill, HBM via "
                                     "device.memory_stats())"),
    "metric_series_limit": (int, 10000,
                            "max distinct (name, tags) series the control "
                            "plane keeps; excess series are dropped and "
                            "counted"),
    # --- metrics history & post-mortem bundles ---
    "metrics_history_capacity": (int, 120,
                                 "snapshot slots of the FINEST metrics-"
                                 "history ring on the control plane "
                                 "(coarser levels scale off it: level i "
                                 "keeps capacity*(2+i)/2 slots, so the "
                                 "default 120 yields 120/180/240); 0 "
                                 "disables the whole history plane — "
                                 "no periodic snapshots, no "
                                 "metrics_history queries, no doctor "
                                 "trends"),
    "metrics_history_steps": (str, "1,10,60",
                              "comma-separated seconds-per-snapshot of "
                              "each history resolution level, finest "
                              "first (multi-resolution ring: recent "
                              "history is fine-grained, older history "
                              "coarsens instead of vanishing)"),
    "metrics_history_max_bytes": (int, 8 << 20,
                                  "hard byte cap on the whole metrics-"
                                  "history ring (estimated); oldest "
                                  "finest-level frames evict first when "
                                  "over budget, so retention degrades "
                                  "gracefully under series churn"),
    "debug_bundle_on_failure": (bool, True,
                                "auto-capture a post-mortem debug "
                                "bundle (rtpu debug-bundle) on terminal "
                                "failures: collective reform budget "
                                "exhaustion, memory-monitor OOM kills, "
                                "and driver shutdown on an uncaught "
                                "error — a chaos casualty leaves a "
                                "corpse `rtpu autopsy` can read"),
    "debug_bundle_dir": (str, "",
                         "directory auto-captured debug bundles are "
                         "written to (default: the session dir when "
                         "known, else the system temp dir)"),
    # --- debugging / stall detection ---
    "stall_detector_interval_s": (float, 5.0,
                                  "control-plane stall sweep period; "
                                  "0 disables the detector"),
    "stall_pending_threshold_s": (float, 30.0,
                                  "warn (TASK_STALL event, with a "
                                  "diagnosed cause) when a task sits in "
                                  "a pending state this long; 0 disables"),
    "stall_running_threshold_s": (float, 300.0,
                                  "warn when a task has been RUNNING "
                                  "this long; 0 disables"),
    "profiler_max_duration_s": (float, 60.0,
                                "hard cap on one `rtpu profile` "
                                "sampling run"),
    "profiler_default_interval_ms": (int, 10,
                                     "default sampling period of the "
                                     "wall-clock profiler"),
    # --- protocol / wire transport ---
    "socket_send_buffer_bytes": (int, 1 << 21,
                                 "SO_SNDBUF requested for control-plane "
                                 "sockets"),
    "socket_recv_buffer_bytes": (int, 1 << 21,
                                 "SO_RCVBUF requested for control-plane "
                                 "sockets"),
    "transport_max_batch_msgs": (int, 128,
                                 "max messages the connection writer "
                                 "coalesces into one BATCH frame"),
    "transport_max_batch_bytes": (int, 1 << 20,
                                  "approximate payload cap of one "
                                  "coalesced BATCH frame (estimated "
                                  "pre-pickle; large messages get their "
                                  "own frame)"),
    "transport_queue_depth": (int, 1024,
                              "bounded per-connection send queue; "
                              "producers block above this depth "
                              "(backpressure)"),
    "transport_oob_threshold_bytes": (int, 64 << 10,
                                      "pickle-5 buffers >= this ship "
                                      "out-of-band as zero-copy iovecs "
                                      "instead of inside the pickle "
                                      "stream"),
    "rpc_inline_chunk_bytes": (int, 1 << 20, "frame chunking for large messages"),
    # --- collectives ---
    "collective_chunk_bytes": (int, 1 << 20,
                               "ring collectives split tensors into chunks "
                               "of this size so chunk k+1 transmits while "
                               "chunk k reduces (pipelining grain)"),
    "collective_tree_threshold_bytes": (int, 32 << 10,
                                        "payloads below this use a binomial "
                                        "tree allreduce (latency-bound "
                                        "regime) instead of the ring "
                                        "(bandwidth-bound regime)"),
    "collective_timeout_s": (float, 60.0,
                             "default deadline of one collective call; a "
                             "rank that dies mid-collective surfaces a "
                             "TimeoutError on every survivor within this"),
    "collective_call_ttl_s": (float, 120.0,
                              "coordinator-side sweep: call records and "
                              "mailbox posts older than this whose group "
                              "members never completed/acked are dropped "
                              "(a timed-out rank must not leak its "
                              "partial contribution forever)"),
    "collective_p2p_enabled": (bool, True,
                               "route collective payloads peer-to-peer "
                               "over the zero-copy transport; off = "
                               "degenerate fallback through the "
                               "coordinator actor (control plane)"),
    "collective_algo": (str, "auto",
                        "force one collective schedule (ring | tree | "
                        "hierarchical | star); auto consults the "
                        "size x topology x dtype selection table "
                        "(_select_schedule) per call"),
    "collective_hierarchical_threshold_bytes": (int, 256 << 10,
                                                "payloads at/above this on a "
                                                "multi-node group with "
                                                "co-located ranks run the "
                                                "two-level hierarchical "
                                                "schedule (intra-node reduce "
                                                "-> inter-node leader ring "
                                                "-> intra-node broadcast); "
                                                "below it the flat ring's "
                                                "fewer staging hops win"),
    "collective_wire_dtype": (str, "exact",
                              "wire precision of INTER-node hops in "
                              "hierarchical reductions: exact (default, "
                              "bit-exact) | bf16 (~2x wire reduction) | "
                              "int8-blockscale (~4x, per-block max-abs "
                              "scales). Intra-node hops and non-reduction "
                              "ops always stay exact"),
    "collective_quant_block_elems": (int, 256,
                                     "block size (elements) of the "
                                     "int8-blockscale wire format; one "
                                     "float32 scale rides along per "
                                     "block"),
    "collective_reform_mode": (str, "replace",
                               "how a group heals after a dead-rank "
                               "verdict: replace (wait for a restarted "
                               "rank to re-enter with the same rank) | "
                               "shrink (contract the world to the "
                               "survivors, renumbered contiguously, "
                               "once arrivals quiesce for the grace "
                               "window)"),
    "collective_reform_retries": (int, 2,
                                  "reform+re-issue attempts the "
                                  "fault-tolerant wrappers "
                                  "(ft_allreduce / FaultTolerantGroup) "
                                  "make per call before surfacing the "
                                  "failure"),
    "collective_reform_timeout_s": (float, 30.0,
                                    "deadline of one reform round: in "
                                    "replace mode, how long survivors "
                                    "wait for the restarted "
                                    "replacement rank to re-join "
                                    "before the reform itself fails "
                                    "with a clear error"),
    "collective_reform_grace_s": (float, 5.0,
                                  "shrink mode: the round resolves "
                                  "once no new rank has re-joined for "
                                  "this long — stragglers that arrive "
                                  "within the window stay members"),
    "actor_checkpoint_interval_s": (float, 0.0,
                                    "checkpoint an actor defining "
                                    "save_checkpoint() when at least "
                                    "this many seconds have passed "
                                    "since the last capture, checked "
                                    "at each call completion (the "
                                    "worker's safe quiescent point — "
                                    "idle actors mutate no state, so "
                                    "no between-call tick is needed); "
                                    "rides the same seq-guarded plane "
                                    "path as the call-count trigger. "
                                    "0 disables the time trigger"),
    "actor_checkpoint_interval_calls": (int, 0,
                                        "checkpoint an actor defining "
                                        "save_checkpoint() every N "
                                        "completed calls (captured "
                                        "BEFORE the call's result is "
                                        "reported, so an observed "
                                        "completion implies checkpoint "
                                        "durability); 0 = only on "
                                        "demand via "
                                        "ray_tpu.actor_checkpoint()"),
    "flight_recorder_capacity": (int, 4096,
                                 "event slots in the per-process "
                                 "collective flight-recorder ring "
                                 "(always-on, lock-free appends); 0 "
                                 "disables recording AND the timeout "
                                 "hang diagnosis"),
    "coll_progress_timeout_s": (float, 2.0,
                                "deadline for one COLL_PROGRESS "
                                "watermark fan-out (hang diagnosis; "
                                "answered on reader threads, so even "
                                "wedged ranks reply within this)"),
    "object_transfer_chunk_bytes": (int, 8 << 20,
                                    "cross-host object pulls stream in "
                                    "chunks of this size (reference: "
                                    "object_manager chunked Push/Pull)"),
    "grpc_equivalent_port": (int, 0, "tcp port for the head control plane (0 = unix socket)"),
    # --- serve request observability ---
    "request_log_capacity": (int, 256,
                             "per-replica structured access-log ring "
                             "slots (request_id, route, status, "
                             "latency, queue wait, batch size); 0 "
                             "disables the whole request-observability "
                             "plane — no request metadata attaches, no "
                             "ingress/queue/replica spans, no "
                             "digests, restoring the pre-PR request "
                             "hot path"),
    "serve_slow_request_threshold_s": (float, 1.0,
                                       "serve requests slower than "
                                       "this are promoted to a "
                                       "SLOW_REQUEST cluster event "
                                       "(errors always promote as "
                                       "REQUEST_ERROR); 0 disables "
                                       "slow-request promotion"),
    # --- lineage ---
    "max_lineage_bytes": (int, 100 * (1 << 20),
                          "lineage footprint cap (reference: task_manager.h:180)"),
    # --- logging ---
    "log_to_driver": (bool, True, "forward worker stdout/stderr to the driver"),
}


# Renamed knobs: old name -> canonical name. Old env vars
# (RTPU_<OLD_NAME>) and _system_config keys keep working; attribute
# reads of the old name resolve to the canonical value.
_ALIASES: Dict[str, str] = {
    "max_inline_object_bytes": "object_store_shm_threshold_bytes",
    "object_spilling_threshold": "object_store_spill_threshold",
    "spill_directory": "object_store_spill_dir",
}


class _Config:
    """Process-wide config singleton. Read via attribute access."""

    def __init__(self):
        self._values: Dict[str, Any] = {}
        self.reload()

    def reload(self, system_config: Dict[str, Any] | None = None) -> None:
        values: Dict[str, Any] = {}
        for name, (typ, default, _help) in _CONFIG_DEFS.items():
            raw = os.environ.get(_ENV_PREFIX + name.upper())
            if raw is not None:
                values[name] = self._parse(typ, raw)
            else:
                values[name] = default
        for old, new in _ALIASES.items():
            raw = os.environ.get(_ENV_PREFIX + old.upper())
            if (raw is not None
                    and os.environ.get(_ENV_PREFIX + new.upper()) is None):
                values[new] = self._parse(_CONFIG_DEFS[new][0], raw)
        if system_config:
            for key, val in system_config.items():
                key = _ALIASES.get(key, key)
                if key not in _CONFIG_DEFS:
                    raise ValueError(f"unknown config key: {key}")
                values[key] = val
        self._values = values

    @staticmethod
    def _parse(typ, raw: str):
        if typ is bool:
            return raw.lower() in ("1", "true", "yes", "on")
        if typ in (int, float, str):
            return typ(raw)
        return json.loads(raw)

    def __getattr__(self, name: str):
        try:
            return self._values[_ALIASES.get(name, name)]
        except KeyError:
            raise AttributeError(name) from None

    def __reduce__(self):
        # the singleton must never ship by value: function/class blobs
        # pickled by value (cloudpickle) capture any CONFIG global
        # their bodies reference, and a value-pickled _Config would (a)
        # hit __getattr__ recursion before _values exists on unpickle
        # and (b) freeze the ORIGIN process's table into the
        # destination. Resolve to the destination's own singleton.
        return (_current_config, ())

    def dump(self) -> Dict[str, Any]:
        return dict(self._values)


def _current_config() -> "_Config":
    return CONFIG


CONFIG = _Config()


def fw_importable_without_path() -> bool:
    """True when ray_tpu is pip-installed (editable or wheel), i.e. a
    spawned interpreter can ``import ray_tpu`` with no PYTHONPATH help.
    Dev checkouts run via cwd/PYTHONPATH return False and worker spawn
    injects the framework root (reference: ``python/setup.py:103`` —
    the reference is always installed; here both modes work)."""
    global _FW_INSTALLED
    if _FW_INSTALLED is None:
        try:
            import importlib.metadata as _md
            _md.distribution("ray-tpu")
            _FW_INSTALLED = True
        except Exception:
            _FW_INSTALLED = False
    return _FW_INSTALLED


_FW_INSTALLED = None
