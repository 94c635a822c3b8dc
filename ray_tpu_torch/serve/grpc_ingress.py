"""gRPC ingress for Serve.

Reference: ``serve/_private/proxy.py:613`` gRPCProxy + the
``serve/generated/serve_pb2_grpc`` service. Here the service is a
GENERIC gRPC handler (no compiled protos — the image carries grpcio
but not protoc-generated stubs): JSON-bytes in/out on two methods,

* ``/rtpu.serve.Ingress/Call``   unary-unary   {"deployment", "arg",
  "multiplexed_model_id"?} -> {"result"} | {"error"}
* ``/rtpu.serve.Ingress/Stream`` unary-stream  same request, one JSON
  frame per produced item, terminal {"error"} frame on mid-stream
  failure (mirrors the HTTP NDJSON contract).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

SERVICE = "rtpu.serve.Ingress"


def _handler(gateway):
    import grpc

    def _parse(data: bytes):
        try:
            req = json.loads(data or b"{}")
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as e:
            return None, {}, json.dumps(
                {"error": f"bad request: {e}"}).encode()
        name = req.get("deployment")
        if not name or f"/{name}" not in gateway.routes():
            return None, req, json.dumps(
                {"error": f"no deployment {name!r}"}).encode()
        return name, req, None

    def call(data: bytes, context) -> bytes:
        name, req, err = _parse(data)
        if err is not None:
            return err
        try:
            # a caller-supplied "request_id" is honored (mirrors the
            # HTTP X-Request-ID contract)
            result = gateway.call(name, req.get("arg"),
                                  model_id=req.get(
                                      "multiplexed_model_id"),
                                  request_id=req.get("request_id"),
                                  proto="grpc")
            return json.dumps({"result": result}).encode()
        except Exception as e:   # noqa: BLE001 — wire errors as JSON
            return json.dumps({"error": str(e)}).encode()

    def stream(data: bytes, context):
        name, req, err = _parse(data)
        if err is not None:
            yield err
            return
        try:
            it = gateway.stream(name, req.get("arg"),
                                model_id=req.get(
                                    "multiplexed_model_id"),
                                request_id=req.get("request_id"),
                                proto="grpc")
            for item in it:
                yield json.dumps({"item": item}).encode()
        except Exception as e:   # noqa: BLE001 — terminal error frame
            yield json.dumps({"error": str(e)}).encode()

    ident = lambda b: b          # noqa: E731 — bytes in, bytes out
    return grpc.method_handlers_generic_handler(SERVICE, {
        "Call": grpc.unary_unary_rpc_method_handler(
            call, request_deserializer=ident, response_serializer=ident),
        "Stream": grpc.unary_stream_rpc_method_handler(
            stream, request_deserializer=ident,
            response_serializer=ident),
    })


def start_grpc(host: str = "127.0.0.1", port: int = 0):
    """Start the gRPC ingress; returns (server, "host:port")."""
    from concurrent import futures

    import grpc

    from .api import _GatewayHandler

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    server.add_generic_rpc_handlers((_handler(_GatewayHandler()),))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise RuntimeError(f"could not bind gRPC ingress on "
                           f"{host}:{port}")
    server.start()
    return server, f"{host}:{bound}"


# ---------------------------------------------------------- client side

def grpc_call(address: str, deployment: str, arg: Any = None, *,
              multiplexed_model_id: Optional[str] = None,
              timeout: float = 30.0) -> Dict[str, Any]:
    """Convenience unary client (tests/CLIs; any gRPC client works)."""
    import grpc

    req: Dict[str, Any] = {"deployment": deployment, "arg": arg}
    if multiplexed_model_id:
        req["multiplexed_model_id"] = multiplexed_model_id
    with grpc.insecure_channel(address) as ch:
        fn = ch.unary_unary(f"/{SERVICE}/Call",
                            request_serializer=lambda b: b,
                            response_deserializer=lambda b: b)
        return json.loads(fn(json.dumps(req).encode(), timeout=timeout))


def grpc_stream(address: str, deployment: str, arg: Any = None, *,
                multiplexed_model_id: Optional[str] = None,
                timeout: float = 60.0):
    """Convenience streaming client: yields decoded item frames."""
    import grpc

    req: Dict[str, Any] = {"deployment": deployment, "arg": arg}
    if multiplexed_model_id:
        req["multiplexed_model_id"] = multiplexed_model_id
    with grpc.insecure_channel(address) as ch:
        fn = ch.unary_stream(f"/{SERVICE}/Stream",
                             request_serializer=lambda b: b,
                             response_deserializer=lambda b: b)
        for frame in fn(json.dumps(req).encode(), timeout=timeout):
            yield json.loads(frame)
