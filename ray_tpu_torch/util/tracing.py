"""Distributed tracing: spans with cross-process context propagation.

Reference analogue: ``python/ray/util/tracing/`` — OpenTelemetry spans
around task submission/execution with the trace context carried inside
the task spec. Same model here without the otel dependency (it is not a
baked-in package): W3C-style ids (128-bit trace, 64-bit span), a
thread-local context stack, automatic ``task::<name>`` spans around
remote execution, and export to the control plane where
``state.api.list_spans()`` / ``trace_timeline()`` read them back.

Enable with ``init(_system_config={"tracing_enabled": True})`` (or
``RTPU_TRACING_ENABLED=1``). Disabled, every hook is a no-op.

Where torch's profiler is recording on the calling thread, a span also
opens a ``torch.profiler.record_function`` of its name for its length,
with tracing on or off, so the span lands on the profiler's own clock and
the profiler links the kernels launched under it. The check finds torch
in ``sys.modules`` and never imports it: a process that has not loaded
torch pays nothing for it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from .._private import locksan
from .._private.config import CONFIG

_local = threading.local()
_buffer: List[dict] = []
_buffer_lock = locksan.lock("tracing.buffer")
_MAX_BUFFER = 10_000


def enabled() -> bool:
    return bool(CONFIG.tracing_enabled)


def _rand_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def current_span() -> Optional[dict]:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def get_current_context() -> Optional[Dict[str, str]]:
    """Propagatable (trace_id, span_id) of the active span, or an
    inherited remote parent when no local span is open."""
    span = current_span()
    if span is not None:
        return {"trace_id": span["trace_id"], "span_id": span["span_id"]}
    return getattr(_local, "remote_parent", None)


def propagation_context() -> Optional[Dict[str, str]]:
    """What a submitter puts into the task spec. When tracing is on but
    no span is open, an EMPTY dict still rides along: it tells the
    executing node "trace this" even if that node's own config has
    tracing off (remote nodes don't see the driver's _system_config).
    An OPEN span propagates even when this process's config has tracing
    off — force-traced spans (serve request ingress, a spec that said
    "trace this") must not lose their trace at the next task boundary."""
    span = current_span()
    if span is not None:
        return {"trace_id": span["trace_id"], "span_id": span["span_id"]}
    if not enabled():
        return None
    return get_current_context() or {}


def set_remote_parent(ctx: Optional[Dict[str, str]]) -> None:
    """Adopt a caller's context (worker-side, before running a task)."""
    _local.remote_parent = ctx


def _new_span(name: str, parent: Optional[Dict[str, str]],
              attributes: Optional[Dict[str, Any]]) -> dict:
    return {
        "trace_id": (parent["trace_id"] if parent and "trace_id" in parent
                     else _rand_id(16)),
        "span_id": _rand_id(8),
        "parent_id": (parent["span_id"] if parent and "span_id" in parent
                      else None),
        "name": name,
        "start_time": time.time(),
        "end_time": None,
        "attributes": dict(attributes or {}),
        "status": "OK",
        "pid": os.getpid(),
    }


def _profiling() -> bool:
    """Whether torch's profiler records on this thread; False where torch
    is not loaded (or is still being imported by another thread)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return torch.autograd._profiler_enabled()
    except AttributeError:
        return False


def _profiler_range(name: str):
    """The entered ``record_function`` of `name`, or None where torch's
    profiler does not record on this thread."""
    if not _profiling():
        return None
    import torch
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


_NOOP = contextlib.nullcontext()


class _Span:
    """`start_span`'s context: the buffered span (when traced) and the
    profiler's range of the same name (when torch's profiler records)."""

    __slots__ = ("name", "attributes", "traced", "span", "rf")

    def __init__(self, name: str, attributes: Optional[Dict[str, Any]],
                 traced: bool):
        self.name, self.attributes, self.traced = name, attributes, traced
        self.span = self.rf = None

    def __enter__(self) -> Optional[dict]:
        self.rf = _profiler_range(self.name)
        if self.traced:
            self.span = _new_span(self.name, get_current_context(),
                                  self.attributes)
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            stack.append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        span = self.span
        if span is not None:
            if exc_type is not None:
                span["status"] = f"ERROR:{exc_type.__name__}"
            span["end_time"] = time.time()
            _local.stack.pop()
            _record(span)
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        return False


def start_span(name: str, attributes: Optional[Dict[str, Any]] = None,
               force: bool = False):
    """Open a span as a child of the current context. Yields the span
    dict (mutable: add attributes mid-flight), or None when this process
    does not trace. ``force`` traces even when local config has tracing
    off (used when the caller's spec says the submitting process is
    tracing). Untraced, the span still opens the profiler's range where
    torch's profiler records."""
    traced = force or enabled()
    if not traced and not _profiling():
        return _NOOP
    return _Span(name, attributes, traced)


def begin_span(name: str, parent: Optional[Dict[str, str]],
               attributes: Optional[Dict[str, Any]] = None) -> dict:
    """Stackless span for contexts where thread-local nesting is wrong
    (asyncio actors interleave many calls on one loop thread)."""
    span = _new_span(name, parent, attributes)
    rf = _profiler_range(name)
    if rf is not None:
        span["_profiler_range"] = rf
    return span


def end_span(span: Optional[dict], error: Optional[str] = None) -> None:
    if span is None:
        return
    span["end_time"] = time.time()
    if error:
        span["status"] = f"ERROR:{error}"
    rf = span.pop("_profiler_range", None)
    if rf is not None:
        rf.__exit__(None, None, None)
    _record(span)


def _record(span: dict) -> None:
    with _buffer_lock:
        _buffer.append(span)
        if len(_buffer) > _MAX_BUFFER:
            del _buffer[:len(_buffer) - _MAX_BUFFER]


def drain() -> List[dict]:
    """Take all locally-buffered finished spans (flush transport)."""
    with _buffer_lock:
        out, _buffer[:] = list(_buffer), []
    return out


def flush() -> None:
    """Ship buffered spans to the control plane via the connected
    client (driver or worker). No-op when nothing is buffered. Not
    gated on ``enabled()``: a worker may hold force-traced spans while
    its own config has tracing off."""
    spans = drain()
    if not spans:
        return
    from .._private import context as _ctx
    client = _ctx.current_client
    if client is None:
        _local_requeue(spans)
        return
    try:
        client.send_profile_event("spans", spans)
    except Exception:          # noqa: BLE001 — tracing must never break work
        pass


_last_flush = 0.0


def maybe_flush(min_interval_s: float = 0.2) -> None:
    """Rate-limited flush for per-request call sites (the serve
    gateway): frequent enough that request lanes assemble promptly
    under traffic, bounded so a request storm doesn't pay one
    control-plane span frame each. Readers that need freshness
    (``state.list_spans`` / the timeline's request-lane builder) call
    ``flush()`` directly."""
    global _last_flush
    now = time.monotonic()
    if now - _last_flush >= min_interval_s:
        _last_flush = now
        flush()


def _local_requeue(spans: List[dict]) -> None:
    """Put drained-but-unshippable spans back at the buffer head. Clamp
    to _MAX_BUFFER afterwards (dropping the OLDEST overflow): repeated
    failed flushes must not grow the buffer without bound."""
    with _buffer_lock:
        _buffer[:0] = spans
        if len(_buffer) > _MAX_BUFFER:
            del _buffer[:len(_buffer) - _MAX_BUFFER]
