"""Per-request serve context: request ids and their propagation.

Reference analogue: ``serve/_private/request_context.py`` — every
request entering Serve gets a request id carried in a contextvar
through proxy → router → replica, readable from user code via
``serve.get_request_id()``. Here the context is a plain mutable dict
(request_id, deployment, route, proto, enqueued_at, optionally
model_id/batch_size) that the ingress creates, the handle ships to the
replica as a reserved kwarg, and the replica re-binds around the user
callable (and around streaming iteration) — so nested ``@serve.batch``
collectors and user code observe the request they serve.

The whole plane is gated by ``request_log_capacity > 0``: at 0 no
request metadata attaches anywhere and the request path is exactly the
pre-instrumentation code.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import time
from typing import Any, Dict, Optional

from .._private.config import CONFIG

_current: "contextvars.ContextVar[Optional[Dict[str, Any]]]" = \
    contextvars.ContextVar("rtpu_serve_request", default=None)

# request-id = 8 random hex (per process, drawn once) + 8 hex counter:
# globally unique without an os.urandom syscall per request (ids are
# minted on the request hot path)
_rid_prefix = os.urandom(4).hex()
_rid_counter = itertools.count(1)


def enabled() -> bool:
    # direct _values read: this gates every handle call (both arms of
    # the request_ab gate) and __getattr__ dispatch costs ~0.4µs
    return CONFIG._values["request_log_capacity"] > 0


def new_request_id() -> str:
    return f"{_rid_prefix}{next(_rid_counter) & 0xffffffff:08x}"


def make(deployment: str, route: Optional[str] = None,
         request_id: Optional[str] = None,
         proto: str = "python") -> Dict[str, Any]:
    """A fresh request context dict (the ingress entry point)."""
    return {
        "request_id": request_id or new_request_id(),
        "deployment": deployment,
        "route": route or f"/{deployment}",
        "proto": proto,
        "enqueued_at": time.time(),
    }


def current() -> Optional[Dict[str, Any]]:
    return _current.get()


def get_request_id() -> str:
    """Inside a deployment handler (or any code on the request path):
    the current request's id, or "" outside a request."""
    ctx = _current.get()
    return (ctx or {}).get("request_id", "")


def bind(meta: Optional[Dict[str, Any]]):
    return _current.set(meta)


def unbind(token) -> None:
    _current.reset(token)
