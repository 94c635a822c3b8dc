"""Shared scaffold for the head node's HTTP surfaces (job REST,
dashboard). One place for JSON plumbing and server lifecycle so fixes
don't have to be made per-module."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class JsonHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):   # quiet
        pass

    def _json(self, code: int, payload,
              headers: Optional[dict] = None) -> None:
        # default=str: handler results may carry numpy scalars/bytes —
        # stringify rather than turning a good reply into a 500
        body = json.dumps(payload, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)

    def _html(self, body: str) -> None:
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self):
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n) or b"{}")


class HttpServerBase:
    """ThreadingHTTPServer wrapper with a non-leaking stop()."""

    thread_name = "rtpu-http"

    def __init__(self, handler_cls, host: str = "0.0.0.0", port: int = 0,
                 **handler_attrs):
        handler = type("BoundHandler", (handler_cls,), handler_attrs)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=self.thread_name, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        # shutdown() only stops serve_forever; the listening socket (and
        # its fd/port) stays bound until close
        self._httpd.server_close()
