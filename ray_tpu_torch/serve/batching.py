"""@serve.batch — dynamic request batching inside a replica.

Reference: ``python/ray/serve/batching.py`` (``@serve.batch`` queues
concurrent calls, fires the underlying function once per batch).
Implementation: a per-function collector thread gathers requests until
``max_batch_size`` or ``batch_wait_timeout_s`` and invokes the wrapped
callable with the list; callers block on their slot's future. Works with
threaded actors (``max_concurrency > 1``) — concurrency is what creates
batchable simultaneous requests.
"""

from __future__ import annotations

import functools
import queue as _queue
import threading
import time as _time

from .._private import locksan
from .._private import telemetry
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

from . import request_context as _rc

M_SERVE_BATCH_SIZE_DIGEST = telemetry.define(
    "digest", "rtpu_serve_batch_size_digest",
    "Streaming quantile digest of @serve.batch batch sizes per "
    "deployment (how well concurrent requests coalesce)")


class _Batcher:
    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self.q: "_queue.Queue" = _queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = locksan.lock("serve.batcher")

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()

    def _loop(self):
        while True:
            item = self.q.get()          # (arg, future, req_meta, trace)
            t_first = _time.monotonic()
            batch = [item]
            # absolute deadline per batch: a fixed per-get timeout would
            # reset on every arrival, making the first caller wait up to
            # (max_batch_size-1)*timeout under a trickle of requests
            deadline = t_first + self.timeout_s
            while len(batch) < self.max_batch_size:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except _queue.Empty:
                    break
            args = [it[0] for it in batch]
            futures = [it[1] for it in batch]
            try:
                # accounting must never break the batch: an exception
                # here (thread exhaustion in a lazy flusher start,
                # interpreter teardown) would kill the collector with
                # every member's future unresolved — callers block on
                # fut.result() with no timeout
                self._note_batch(batch, t_first)
            except Exception:   # noqa: BLE001 — observability only
                pass
            # bind the batch LEADER's request context around the user
            # function: one invocation serves N requests, so a single
            # id is inherently approximate, but get_request_id() inside
            # a batched body should name a member of THIS batch, not ""
            # (the per-member ids live in each access-log row)
            lead = next((it[2] for it in batch
                         if len(it) > 2 and it[2]), None)
            tok = _rc.bind(lead) if lead is not None else None
            try:
                results = self.fn(args)
                if results is None or len(results) != len(args):
                    raise ValueError(
                        "@serve.batch function must return one result per "
                        f"input ({len(args)} inputs)")
                for fut, res in zip(futures, results):
                    fut.set_result(res)
            except Exception as e:
                for fut in futures:
                    fut.set_exception(e)
            finally:
                if tok is not None:
                    _rc.unbind(tok)

    @staticmethod
    def _note_batch(batch, t_first: float) -> None:
        """Request-plane accounting for one assembled batch: stamp each
        member request's batch size (the replica's access-log row reads
        it back), record the per-deployment batch-size digest, and emit
        one ``request::batch_assemble`` span parented to the first
        member's trace (span start = first arrival, end = invoke)."""
        metas = [it[2] for it in batch if len(it) > 2 and it[2]]
        if not metas:
            return                    # plane off / outside a request
        n = len(batch)
        for meta in metas:
            meta["batch_size"] = n
        deployment = metas[0].get("deployment", "default")
        telemetry.digest_observe(M_SERVE_BATCH_SIZE_DIGEST, float(n),
                                 (("deployment", deployment),))
        from ..util import tracing
        parent = next((it[3] for it in batch
                       if len(it) > 3 and it[3]), None)
        if parent is not None or tracing.enabled():
            span = tracing.begin_span(
                "request::" + "batch_assemble", parent,
                attributes={"deployment": deployment, "batch_size": n,
                            "request_id": metas[0].get("request_id")})
            wait = _time.monotonic() - t_first
            span["start_time"] = _time.time() - wait
            tracing.end_span(span)

    def submit(self, arg: Any) -> Any:
        self._ensure_thread()
        fut: Future = Future()
        # carry the caller's request context + trace ctx to the
        # collector thread (contextvars/thread-locals don't cross)
        meta = _rc.current() if _rc.enabled() else None
        trace = None
        if meta is not None:
            from ..util import tracing
            trace = tracing.get_current_context()
        self.q.put((arg, fut, meta, trace))
        return fut.result()


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorate a method taking a LIST of requests; singular calls are
    coalesced into batches transparently."""

    def decorator(fn):
        attr = f"__rtpu_batcher_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(self, request):
            b = getattr(self, attr, None)
            if b is None:
                b = _Batcher(lambda args: fn(self, args), max_batch_size,
                             batch_wait_timeout_s)
                setattr(self, attr, b)
            return b.submit(request)

        wrapper._rtpu_is_batched = True
        return wrapper

    if _fn is not None:
        return decorator(_fn)
    return decorator
