"""Networked control plane: GCS service + remote client.

Equivalent role to the reference's GCS server / client pair
(``src/ray/gcs/gcs_server/gcs_server.h``, ``gcs_service.proto:63-699``
— node/actor/PG/KV/job tables behind RPC, plus pubsub push). The head
node process hosts ``GcsServer`` wrapping the in-process
``GlobalControlPlane``; every other node process (and remote driver)
talks to it through ``RemoteControlPlane``, which duck-types the plane's
API so ``NodeService`` works unchanged over either.

Failure detection is two-channel, like the reference's
health-check-manager + connection state: a node is declared dead when
its GCS connection drops OR its heartbeats go stale
(``health_check_period_ms`` × ``health_check_failure_threshold``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import locksan
from . import protocol as P
from . import serialization as ser
from .config import CONFIG
from .gcs import GlobalControlPlane, NodeInfo
from .ids import NodeID
from .rpc import RpcChannel

# every public method of the plane a remote may invoke
_ALLOWED = frozenset({
    "register_node", "remove_node", "alive_nodes", "heartbeat", "get_node",
    "nodes_snapshot", "cluster_resources", "register_actor", "get_actor",
    "set_actor_state", "lookup_named_actor", "register_job", "finish_job",
    "kv_put", "kv_get", "kv_del", "kv_keys", "publish_location",
    "lookup_location", "drop_location", "register_pg", "get_pg",
    "remove_pg", "record_task_event", "list_task_events", "publish",
    "actors_snapshot", "directory_snapshot", "pgs_snapshot", "jobs_snapshot",
    "ref_register", "ref_drop", "drop_all_refs", "pin_task_args",
    "unpin_task_args", "pin_contained", "record_lineage", "get_lineage",
    "claim_lineage", "reconstruct_stats",
    "save_actor_checkpoint", "get_actor_checkpoint",
    "record_provenance", "objects_info", "memory_state",
    "record_cluster_event", "list_cluster_events",
    "record_spans", "list_spans", "record_metrics", "metrics_snapshot",
    "metrics_history_query", "metrics_history_dump", "lifecycle_snapshot",
    "events_stats",
    "claim_actor_reroute",
    "requeue_actor_reroute",
    "gen_update", "gen_done", "gen_consumed", "gen_get", "gen_drop",
    "register_pending_pg", "clear_pending_pg", "pending_pgs_snapshot",
})


class GcsServer:
    """TCP front for a GlobalControlPlane (runs in the head node process)."""

    def __init__(self, plane: GlobalControlPlane, host: str = "0.0.0.0",
                 port: int = 0):
        self.plane = plane
        self._listener = P.listen_tcp(host, port)
        self.port = self._listener.getsockname()[1]
        self._conns: Dict[int, P.Connection] = {}
        self._conn_node: Dict[int, NodeID] = {}      # node conns, for death
        self._subs: Dict[str, set] = {}              # channel -> conn keys
        self._hooked: set = set()                    # channels with fanout
        self._lock = locksan.lock("gcs_server.conns")
        self._next_key = 1
        self._stopped = threading.Event()
        for t in (self._accept_loop, self._sweep_loop):
            th = threading.Thread(target=t, daemon=True,
                                  name=f"rtpu-gcs-{t.__name__}")
            th.start()

    # ------------------------------------------------------------- serving
    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = P.Connection(sock)
            with self._lock:
                key = self._next_key
                self._next_key += 1
                self._conns[key] = conn
            threading.Thread(target=self._serve_conn, args=(key, conn),
                             daemon=True, name="rtpu-gcs-conn").start()

    def _serve_conn(self, key: int, conn: P.Connection) -> None:
        while True:
            # burst receive: a node's coalesced cast stream (heartbeats,
            # ref edges, task events) is served per wakeup, not per frame
            msgs = conn.recv_many()
            if msgs is None:
                self._on_conn_closed(key)
                return
            for op, payload in msgs:
                try:
                    if op == P.GCS_CALL:
                        req_id, method, args, kwargs = payload
                        try:
                            result = self._invoke(key, method, args, kwargs)
                            conn.send((P.INFO_REPLY, (req_id, result)))
                        except Exception as e:  # noqa: BLE001 — unblocks
                            conn.send((P.ERROR_REPLY,
                                       (req_id, ser.to_bytes(e))))
                    elif op == P.GCS_CAST:
                        method, args, kwargs = payload
                        try:
                            self._invoke(key, method, args, kwargs)
                        except Exception:
                            pass
                    elif op == P.GCS_SUBSCRIBE:
                        self._subscribe_conn(key, payload)
                except OSError:
                    self._on_conn_closed(key)
                    return

    def _invoke(self, conn_key: int, method: str, args, kwargs) -> Any:
        if method not in _ALLOWED:
            raise ValueError(f"gcs method not allowed: {method}")
        if method == "register_node":
            # remember which conn owns this node: its death is the node's
            info: NodeInfo = args[0]
            with self._lock:
                self._conn_node[conn_key] = info.node_id
        return getattr(self.plane, method)(*args, **kwargs)

    def _subscribe_conn(self, key: int, channel: str) -> None:
        with self._lock:
            self._subs.setdefault(channel, set()).add(key)
            hook = channel not in self._hooked
            if hook:
                self._hooked.add(channel)
        if hook:
            self.plane.subscribe(
                channel, lambda payload, _c=channel: self._fanout(_c, payload))

    def _fanout(self, channel: str, payload: Any) -> None:
        with self._lock:
            keys = list(self._subs.get(channel, ()))
            conns = [(k, self._conns.get(k)) for k in keys]
        for key, conn in conns:
            if conn is None:
                continue
            try:
                conn.send((P.EVENT, (channel, payload)))
            except OSError:
                self._on_conn_closed(key)

    def _on_conn_closed(self, key: int) -> None:
        with self._lock:
            conn = self._conns.pop(key, None)
            node_id = self._conn_node.pop(key, None)
            for subs in self._subs.values():
                subs.discard(key)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        if node_id is not None and not self._stopped.is_set():
            info = self.plane.get_node(node_id)
            if info is not None and info.alive:
                self.plane.remove_node(node_id, reason="gcs connection lost")

    # ------------------------------------------------- failure detection
    def _sweep_loop(self) -> None:
        period = CONFIG.health_check_period_ms / 1000.0
        deadline = period * CONFIG.health_check_failure_threshold
        while not self._stopped.wait(period):
            now = time.monotonic()
            for info in self.plane.alive_nodes():
                if now - info.last_heartbeat > deadline:
                    self.plane.remove_node(
                        info.node_id,
                        reason=f"no heartbeat for {deadline:.0f}s")

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass


class RemoteControlPlane:
    """GlobalControlPlane duck-type over a TCP connection to GcsServer.

    Synchronous methods RPC through one ordered channel, so a cast
    (fire-and-forget mutator) followed by a call is observed in order by
    the server. ``alive_nodes`` is cached briefly: the scheduler calls it
    per task submission and per-task RTTs to the GCS would dominate.
    """

    _CASTS = frozenset({
        "heartbeat", "publish_location", "drop_location",
        "record_task_event", "publish", "kv_del", "finish_job",
        "ref_register", "ref_drop", "drop_all_refs", "pin_task_args",
        "unpin_task_args", "pin_contained", "record_lineage",
        "record_provenance",
        "record_cluster_event", "record_spans", "record_metrics",
        "gen_update", "gen_done", "gen_consumed", "gen_drop",
        "register_pending_pg", "clear_pending_pg",
    })

    def __init__(self, address: str):
        host, port = address.rsplit(":", 1)
        self._conn = P.connect_tcp(host, int(port))
        self._subscribers: Dict[str, List[Callable[[Any], None]]] = {}
        self._sub_lock = locksan.lock("gcs_client.subs")
        self._rpc = RpcChannel(self._conn, on_push=self._on_push)
        self._nodes_cache: Optional[List[NodeInfo]] = None
        self._nodes_cache_at = 0.0
        self._nodes_cache_ttl = CONFIG.health_check_period_ms / 1000.0 / 3

    @property
    def closed(self) -> bool:
        return self._rpc.closed

    def _on_push(self, op: int, payload: Any) -> None:
        if op != P.EVENT:
            return
        channel, data = payload
        if channel == "NODE":
            # membership changed; next alive_nodes() refetches
            self._nodes_cache = None
        with self._sub_lock:
            subs = list(self._subscribers.get(channel, ()))
        for cb in subs:
            try:
                cb(data)
            except Exception:
                pass

    def _call(self, method: str, *args, **kwargs) -> Any:
        from . import telemetry
        t0 = time.monotonic()
        try:
            return self._rpc.request(
                P.GCS_CALL, lambda rid: (rid, method, args, kwargs))
        finally:
            telemetry.counter_inc(telemetry.M_GCS_RPC_TOTAL,
                                  tags=(("kind", "call"),
                                        ("method", method)))
            telemetry.hist_observe(telemetry.M_GCS_RPC_LATENCY,
                                   time.monotonic() - t0,
                                   tags=(("method", method),))

    def _cast(self, method: str, *args, **kwargs) -> None:
        from . import telemetry
        if method != "record_metrics":     # the flush frame itself
            telemetry.counter_inc(telemetry.M_GCS_RPC_TOTAL,
                                  tags=(("kind", "cast"),
                                        ("method", method)))
        self._rpc.send(P.GCS_CAST, (method, args, kwargs))

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in _ALLOWED:
            caller = self._cast if name in self._CASTS else self._call
            return lambda *a, **kw: caller(name, *a, **kw)
        raise AttributeError(name)

    # cached: called by the scheduler on every submission
    def alive_nodes(self) -> List[NodeInfo]:
        now = time.monotonic()
        cached = self._nodes_cache
        if cached is not None and now - self._nodes_cache_at < self._nodes_cache_ttl:
            return cached
        nodes = self._call("alive_nodes")
        self._nodes_cache = nodes
        self._nodes_cache_at = now
        return nodes

    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> None:
        with self._sub_lock:
            first = channel not in self._subscribers
            self._subscribers.setdefault(channel, []).append(callback)
        if first:
            self._rpc.send(P.GCS_SUBSCRIBE, channel)

    def close(self) -> None:
        self._rpc.close()
