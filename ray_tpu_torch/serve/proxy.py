"""Per-node HTTP proxies.

Reference: ``serve/_private/proxy_state.py`` (ProxyStateManager — the
controller keeps one HTTPProxy actor alive per cluster node) +
``proxy.py:613`` (HTTPProxy). Here each proxy is a detached actor
pinned to its node with NodeAffinity, running the same JSON/NDJSON
gateway the head's ``serve.start_http`` runs; any node's port serves
every deployment (routing state comes from the controller, which is
location-transparent).

Request observability rides along for free: the shared
``_GatewayHandler`` mints (or adopts, via ``X-Request-ID``) a request
id per request, opens the ``request::ingress`` span, and binds the
request context the handle ships to the replica — so a request through
ANY node's proxy traces and logs identically to one through the head
gateway. The proxy actor's own log lines carry its node in the worker
prefix; replica lines carry their deployment name.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import get, get_actor, kill
from ..api import remote
from .._private.scheduler import NodeAffinitySchedulingStrategy

_PROXY_PREFIX = "SERVE_PROXY:"


@remote(num_cpus=0, max_concurrency=8)
class ProxyActor:
    """One node's HTTP ingress. Runs the gateway HTTP server in this
    actor's process; the bound address is queryable."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 grpc_port: Optional[int] = 0):
        import socket

        from .api import _gateway_server
        self._server, self._addr = _gateway_server(host, port)
        # gRPC side-by-side (reference: proxies serve both protocols);
        # None disables it
        self._grpc_server = None
        self._grpc_addr = None
        if grpc_port is not None:
            from .grpc_ingress import start_grpc
            self._grpc_server, self._grpc_addr = start_grpc(host,
                                                            grpc_port)
        if host == "0.0.0.0":
            # a wildcard bind is not a connectable URL; advertise this
            # node's resolvable address instead (multi-host ingress —
            # loopback binds stay loopback, as configured)
            try:
                ip = socket.gethostbyname(socket.gethostname())
                self._addr = self._addr.replace("0.0.0.0", ip)
            except OSError:
                pass

    def address(self) -> str:
        return self._addr

    def grpc_address(self) -> Optional[str]:
        return self._grpc_addr

    def ready(self) -> bool:
        return True

    def stop(self) -> None:
        self._server.stop()
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=None)


def _alive_nodes() -> List[dict]:
    from ..state.api import list_nodes
    return [n for n in list_nodes() if n.get("alive")]


def ensure_proxies(host: str = "127.0.0.1",
                   port: int = 0) -> Dict[str, str]:
    """Reconcile one proxy per alive node (reference:
    ``ProxyStateManager.update``); returns {node_id_hex: address}.
    Idempotent — existing proxies are kept, new nodes get one."""
    out: Dict[str, str] = {}
    for node in _alive_nodes():
        node_id = node["node_id"]
        name = _PROXY_PREFIX + node_id.hex()
        try:
            proxy = get_actor(name)
        except ValueError:
            proxy = ProxyActor.options(
                name=name, lifetime="detached",
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id, soft=False),
            ).remote(host, port)
        out[node_id.hex()] = get(proxy.address.remote(), timeout=30)
    return out


def proxy_addresses() -> Dict[str, str]:
    """Addresses of currently-live proxies (no reconciliation)."""
    out: Dict[str, str] = {}
    for node in _alive_nodes():
        node_hex = node["node_id"].hex()
        try:
            proxy = get_actor(_PROXY_PREFIX + node_hex)
            out[node_hex] = get(proxy.address.remote(), timeout=5)
        except Exception:   # noqa: BLE001 — absent proxy = no entry
            continue
    return out


def stop_proxies() -> None:
    for node in _alive_nodes():
        try:
            proxy = get_actor(_PROXY_PREFIX + node["node_id"].hex())
        except ValueError:
            continue
        try:
            get(proxy.stop.remote(), timeout=5)
        except Exception:   # noqa: BLE001 — dying proxy is fine
            pass
        try:
            kill(proxy)
        except Exception:   # noqa: BLE001
            pass
