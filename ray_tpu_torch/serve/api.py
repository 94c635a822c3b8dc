"""serve public API: @deployment, run, handles, HTTP gateway.

Reference: ``serve/api.py:479`` (serve.run), ``:265`` (@serve.deployment),
proxies ``_private/proxy.py``. The gateway here is stdlib http.server
(JSON POST /{deployment}) — the reference's uvicorn/ASGI stack is an
infra choice, not a semantic one; routing semantics (handle + p2c) are
identical for HTTP and Python callers.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Callable, Dict, Optional

from .. import get, get_actor, kill
from .._private import serialization as ser
from .controller import ServeController
from .handle import DeploymentHandle

_CONTROLLER_NAME = "rtpu:serve_controller"
_http_server = None


class Deployment:
    """Declarative deployment spec; ``.bind(*args)`` makes an app."""

    def __init__(self, target: Callable, name: str,
                 num_replicas: int = 1,
                 ray_actor_options: Optional[dict] = None,
                 autoscaling_config: Optional[dict] = None,
                 max_concurrent_queries: int = 8):
        self._target = target
        self.name = name
        self.num_replicas = num_replicas
        self.ray_actor_options = ray_actor_options or {}
        self.autoscaling_config = autoscaling_config
        self.max_concurrent_queries = max_concurrent_queries

    def options(self, **kwargs) -> "Deployment":
        merged = dict(
            name=self.name, num_replicas=self.num_replicas,
            ray_actor_options=self.ray_actor_options,
            autoscaling_config=self.autoscaling_config,
            max_concurrent_queries=self.max_concurrent_queries)
        merged.update(kwargs)
        return Deployment(self._target, **merged)

    def bind(self, *init_args, **init_kwargs) -> "Application":
        return Application(self, init_args, init_kwargs)


class Application:
    def __init__(self, deployment: Deployment, init_args: tuple,
                 init_kwargs: dict):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs


def deployment(_target: Optional[Callable] = None, *,
               name: Optional[str] = None, num_replicas: int = 1,
               ray_actor_options: Optional[dict] = None,
               autoscaling_config: Optional[dict] = None,
               max_concurrent_queries: int = 8):
    """``@serve.deployment`` on a class (callable) or function."""

    def wrap(target):
        return Deployment(target, name or target.__name__,
                          num_replicas=num_replicas,
                          ray_actor_options=ray_actor_options,
                          autoscaling_config=autoscaling_config,
                          max_concurrent_queries=max_concurrent_queries)

    if _target is not None:
        return wrap(_target)
    return wrap


def _get_or_create_controller():
    try:
        return get_actor(_CONTROLLER_NAME)
    except ValueError:
        return ServeController.options(name=_CONTROLLER_NAME,
                                       lifetime="detached").remote()


def run(app: Application, *, name: Optional[str] = None,
        route_prefix: Optional[str] = None) -> DeploymentHandle:
    """Deploy an application; blocks until replicas exist."""
    dep = app.deployment
    controller = _get_or_create_controller()
    blob = ser.dumps_function(dep._target)
    get(controller.deploy.remote(
        dep.name, blob, app.init_args, app.init_kwargs,
        dep.num_replicas, dep.ray_actor_options,
        dep.autoscaling_config, dep.max_concurrent_queries))
    return DeploymentHandle(dep.name, controller)


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name, _get_or_create_controller())


def delete(name: str) -> None:
    controller = _get_or_create_controller()
    get(controller.delete.remote(name))


def shutdown() -> None:
    stop_http()
    stop_grpc()
    try:
        from .proxy import stop_proxies
        stop_proxies()
    except Exception:   # noqa: BLE001 — proxies are best-effort on exit
        pass
    try:
        controller = get_actor(_CONTROLLER_NAME)
    except ValueError:
        return
    get(controller.shutdown.remote())
    try:
        kill(controller)
    except Exception:
        pass


# ------------------------------------------------------------- HTTP gateway

class _GatewayHandler:
    """Shared dispatch for the JSON gateway (reference: HTTPProxy,
    ``_private/proxy.py:912``): ``POST /{deployment}`` calls the
    deployment with the parsed JSON body, ``GET /{deployment}`` calls it
    with the query params (or None), ``GET /-/routes`` lists routes.
    Unknown deployments are 404, deployment exceptions 500."""

    _ROUTES_TTL_S = 2.0

    def __init__(self):
        self._handles: Dict[str, DeploymentHandle] = {}
        self._routes_cache: Dict[str, str] = {}
        self._routes_at = 0.0

    def routes(self) -> Dict[str, str]:
        # TTL-cached: the 404 check must not put a controller RPC on
        # every data-path request
        now = time.monotonic()
        if now - self._routes_at > self._ROUTES_TTL_S:
            ctrl = _get_or_create_controller()
            self._routes_cache = {
                f"/{name}": name
                for name in get(ctrl.list_deployments.remote())}
            self._routes_at = now
        return self._routes_cache

    def _handle(self, name: str):
        handle = self._handles.get(name)
        if handle is None:
            handle = get_deployment_handle(name)
            self._handles[name] = handle
        return handle

    @contextlib.contextmanager
    def _ingress(self, name: str, request_id: Optional[str],
                 proto: str, stream: bool):
        """One request's ingress scope: mint/adopt the request id, bind
        the request context the handle ships to the replica, and open
        the force-traced ``request::ingress`` span — so the whole
        request is one trace even when ``tracing_enabled`` is off. The
        span covers whatever runs inside the scope (unary: routing +
        result wait; streaming: routing/submission only — stream
        latency is recorded replica-side at exhaustion). Span shipping
        is rate-limited; the timeline/list_spans readers flush the
        tail themselves."""
        from . import request_context as _rc
        from ..util import tracing
        meta = _rc.make(name, request_id=request_id, proto=proto)
        if stream:
            meta["stream"] = True
        attributes = {"request_id": meta["request_id"],
                      "deployment": name, "route": meta["route"],
                      "proto": proto}
        if stream:
            attributes["stream"] = True
        token = _rc.bind(meta)
        try:
            with tracing.start_span("request::" + "ingress",
                                    attributes=attributes, force=True):
                yield
        finally:
            _rc.unbind(token)
            tracing.maybe_flush()

    def call(self, name: str, arg, model_id: Optional[str] = None,
             request_id: Optional[str] = None, proto: str = "http"):
        """One unary request through the gateway (caller-supplied
        ``X-Request-ID`` honored via ``request_id``)."""
        from . import request_context as _rc
        handle = self._handle(name)
        if model_id:
            handle = handle.options(multiplexed_model_id=model_id)
        if not _rc.enabled():
            return handle.remote(arg).result(timeout=30.0)
        with self._ingress(name, request_id, proto, stream=False):
            return handle.remote(arg).result(timeout=30.0)

    def stream(self, name: str, arg, model_id: Optional[str] = None,
               request_id: Optional[str] = None, proto: str = "http"):
        """Iterator of item values from a streaming deployment handler
        (generator)."""
        from . import request_context as _rc
        handle = self._handle(name)
        if model_id:
            handle = handle.options(multiplexed_model_id=model_id)
        if not _rc.enabled():
            return handle.stream(arg)
        with self._ingress(name, request_id, proto, stream=True):
            return handle.stream(arg)


def _gateway_server(host: str = "127.0.0.1", port: int = 0):
    """Build + start one gateway HTTP server; returns (server, address).
    Used by the driver-local ``start_http`` and by each per-node
    ``ProxyActor`` (reference: one HTTPProxy per node,
    ``_private/proxy.py:613``)."""
    from .._private.http_util import HttpServerBase, JsonHandler

    gateway = _GatewayHandler()

    class Handler(JsonHandler):
        def _dispatch(self, arg_from_body: bool):
            from . import request_context as _rc
            path, _, query = self.path.partition("?")
            name = path.strip("/").split("/")[0]
            # inbound X-Request-ID is honored (distributed callers
            # stitch their own ids through); otherwise minted here —
            # either way the response echoes it in X-RTPU-Request-ID
            rid = None
            rid_headers = {}
            if _rc.enabled():
                rid = (self.headers.get("X-Request-ID")
                       or _rc.new_request_id())
                rid_headers = {"X-RTPU-Request-ID": rid}
            try:
                if path.rstrip("/") == "/-/routes":
                    return self._json(200, gateway.routes())
                if not name or f"/{name}" not in gateway.routes():
                    return self._json(404,
                                      {"error": f"no deployment {name!r}"},
                                      headers=rid_headers)
                if arg_from_body:
                    # an EMPTY body means "no argument" (None), matching
                    # the GET-without-query semantics below
                    n = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(n)
                    arg = json.loads(raw) if raw else None
                else:
                    from urllib.parse import parse_qs
                    q = {k: v[0] if len(v) == 1 else v
                         for k, v in parse_qs(query).items()}
                    arg = q or None
                if self.headers.get("X-RTPU-Stream"):
                    # streaming response: one JSON line per produced
                    # item, written (and flushed) as each arrives —
                    # the client reads incrementally until EOF
                    # (reference: Serve StreamingResponse,
                    # ``_private/proxy.py`` ASGI streaming).
                    # Pull the FIRST item before committing the 200 so
                    # an immediately-failing handler gets a real 500;
                    # later errors become a terminal {"error": ...}
                    # line (headers are already on the wire by then).
                    stream_it = iter(gateway.stream(name, arg,
                                                    request_id=rid))
                    first = _STREAM_END = object()
                    try:
                        first = next(stream_it)
                    except StopIteration:
                        pass
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Connection", "close")
                    for key, value in rid_headers.items():
                        self.send_header(key, value)
                    self.end_headers()

                    def write_line(obj) -> None:
                        self.wfile.write(
                            (json.dumps(obj) + "\n").encode())
                        self.wfile.flush()

                    try:
                        if first is not _STREAM_END:
                            write_line({"item": first})
                            for item in stream_it:
                                write_line({"item": item})
                    except Exception as e:  # noqa: BLE001 — terminal line
                        write_line({"error": str(e)})
                    return None
                result = gateway.call(name, arg, request_id=rid)
                return self._json(200, {"result": result},
                                  headers=rid_headers)
            except Exception as e:   # noqa: BLE001 — always answer JSON
                return self._json(500, {"error": str(e)},
                                  headers=rid_headers)

        def do_POST(self):
            self._dispatch(arg_from_body=True)

        def do_GET(self):
            self._dispatch(arg_from_body=False)

    class Gateway(HttpServerBase):
        thread_name = "rtpu-serve-http"

    server = Gateway(Handler, host=host, port=port)
    server.start()
    return server, f"http://{host}:{server.port}"


def start_http(host: str = "127.0.0.1", port: int = 8000) -> str:
    global _http_server
    # restarting replaces the gateway: the old thread/port must not be
    # orphaned (they'd hold the bind until process exit)
    stop_http()
    _http_server, addr = _gateway_server(host, port)
    return addr


def start(*, proxy_location: str = "HeadOnly",
          http_host: str = "127.0.0.1", http_port: int = 0):
    """Start Serve ingress (reference: ``serve.start(http_options=...)``
    + ``ProxyStateManager``). ``proxy_location``:

    * ``"HeadOnly"`` — one gateway in this driver process.
    * ``"EveryNode"`` — a detached ProxyActor per alive cluster node,
      each serving every deployment; returns {node_id_hex: address}.
    """
    _get_or_create_controller()
    if proxy_location == "EveryNode":
        from .proxy import ensure_proxies
        return ensure_proxies(http_host, http_port)
    if proxy_location == "HeadOnly":
        return start_http(http_host, http_port or 8000)
    raise ValueError(
        f"proxy_location must be 'HeadOnly' or 'EveryNode', "
        f"got {proxy_location!r}")


_grpc_server = None


def start_grpc(host: str = "127.0.0.1", port: int = 0) -> str:
    """Start the gRPC ingress (reference: serve's gRPCProxy); returns
    "host:port". See ``serve/grpc_ingress.py`` for the wire contract."""
    global _grpc_server
    stop_grpc()
    from .grpc_ingress import start_grpc as _start
    _grpc_server, addr = _start(host, port)
    return addr


def stop_grpc() -> None:
    global _grpc_server
    if _grpc_server is not None:
        _grpc_server.stop(grace=None)
        _grpc_server = None


def stop_http() -> None:
    global _http_server
    if _http_server is not None:
        _http_server.stop()
        _http_server = None
