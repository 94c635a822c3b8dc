"""Replica actor wrapping the user callable.

Reference: ``serve/_private/replica.py:494`` (RayServeReplica.
handle_request → user callable, queue metrics for autoscaling).

Request observability: every request arrives with a compact
context tuple (``spec.request_ctx`` baggage set by the handle, re-bound
by the worker around the call — never an extra arg slot) — the replica
measures queue wait (enqueued_at → execution start),
re-binds the request context around the user callable (and streaming
iteration) so ``serve.get_request_id()`` and ``@serve.batch`` see it,
opens ``request::queue_wait`` / ``request::replica_execute`` spans when
the request is traced, records per-deployment latency/queue-wait
quantile digests, appends one structured access-log row into a
fixed-capacity ring, and promotes slow/error requests to cluster
events through the node's EventLogger (PROFILE_EVENT relay — the
replica worker has no logger of its own). All of it is gated by
``request_log_capacity > 0``; at 0 the request path is the
pre-instrumentation code.
"""

from __future__ import annotations

import inspect
import time
from collections import deque

from .._private import context as _pctx
from .._private import locksan
from .._private import telemetry
from .._private.config import CONFIG
from ..api import remote
from ..util import tracing
from . import request_context as _rc

M_SERVE_LATENCY = telemetry.define(
    "histogram", "rtpu_serve_request_latency_seconds",
    "Replica-side request handling latency, tagged by deployment")
M_SERVE_REQUESTS = telemetry.define(
    "counter", "rtpu_serve_requests_total",
    "Requests handled by serve replicas, tagged deployment and "
    "status=ok|error")
M_SERVE_QUEUE_DEPTH = telemetry.define(
    "gauge", "rtpu_serve_replica_queue_depth",
    "Requests executing + queued on this replica (autoscaling signal)")
M_SERVE_LATENCY_DIGEST = telemetry.define(
    "digest", "rtpu_serve_request_latency_digest_seconds",
    "Streaming quantile digest of replica-side request latency per "
    "deployment (p50/p95/p99 for serve_health and the autoscaler)")
M_SERVE_QUEUE_WAIT_DIGEST = telemetry.define(
    "digest", "rtpu_serve_queue_wait_digest_seconds",
    "Streaming quantile digest of request queue wait (handle routing "
    "enqueue -> replica execution start) per deployment")

# access-log ring rows are stored as compact tuples in this field order
# and shaped into dicts lazily on access_log() reads / slow-error
# promotion — the hot path pays one tuple pack, not a 12-key dict build
_ROW_KEYS = ("ts", "request_id", "deployment", "replica", "route",
             "proto", "model_id", "status", "latency_s", "queue_wait_s",
             "batch_size", "error")


def _shape_row(row: tuple) -> dict:
    d = dict(zip(_ROW_KEYS, row))
    d["latency_s"] = round(d["latency_s"], 6)
    d["queue_wait_s"] = round(d["queue_wait_s"], 6)
    return d


@remote(max_concurrency=8)
class Replica:
    def __init__(self, cls_blob: bytes, init_args: tuple,
                 init_kwargs: dict, deployment_name: str = "",
                 replica_tag: str = ""):
        from .._private import serialization as ser
        target = ser.loads_function(cls_blob)
        if isinstance(target, type):
            self._instance = target(*init_args, **init_kwargs)
        else:
            self._instance = target          # plain function deployment
        self._depth = 0
        self._depth_lock = locksan.lock("serve.replica_depth")
        self._deployment = deployment_name or "default"
        self._replica_tag = replica_tag or "0"
        self._default_route = f"/{self._deployment}"
        self._mtags = (("deployment", self._deployment),)
        self._qtags = self._mtags + (("replica", self._replica_tag),)
        # prebound digest series: two records per request ride these
        # (literal tag tuples, not self._mtags — check_metrics reads
        # the keys statically from the digest_series call site)
        self._lat_digest = telemetry.digest_series(
            M_SERVE_LATENCY_DIGEST, (("deployment", self._deployment),))
        self._wait_digest = telemetry.digest_series(
            M_SERVE_QUEUE_WAIT_DIGEST, (("deployment", self._deployment),))
        # structured access log: fixed-capacity ring, GIL-atomic appends
        # (pool threads share it lock-free); capacity 0 disables the
        # whole request plane
        cap = CONFIG.request_log_capacity
        self._request_log: deque = deque(maxlen=max(cap, 1))
        # worker log lines from this process carry the deployment name
        # instead of a bare worker id (`rtpu logs` greppable by
        # deployment; picked up by the worker runtime at creation)
        self.__rtpu_log_label__ = f"{self._deployment}#{self._replica_tag}"

    def _enter(self) -> None:
        with self._depth_lock:
            self._depth += 1
            depth = self._depth
        telemetry.gauge_set(M_SERVE_QUEUE_DEPTH, float(depth), self._qtags)

    def _exit(self, t0: float, ok: bool) -> None:
        with self._depth_lock:
            self._depth -= 1
            depth = self._depth
        telemetry.gauge_set(M_SERVE_QUEUE_DEPTH, float(depth), self._qtags)
        telemetry.hist_observe(M_SERVE_LATENCY, time.monotonic() - t0,
                               self._mtags)
        telemetry.counter_inc(
            M_SERVE_REQUESTS, 1.0,
            self._mtags + (("status", "ok" if ok else "error"),))

    # ------------------------------------------------ request plane
    def _begin_request(self, req):
        """Measure queue wait, bind the request context, and emit the
        ``request::queue_wait`` span when the request is traced (the
        actor-call span propagated from the ingress is the parent, so
        the whole request shares one trace id). ``req`` is the handle's
        compact wire tuple (request_id, route, proto, enqueued_at,
        model_id); the context dict user code sees is built here.
        Returns the per-request state dict, or None when the plane is
        off."""
        if req is None or not isinstance(req, tuple) or len(req) != 5 \
                or CONFIG._values["request_log_capacity"] <= 0:
            return None
        rid, route, proto, enqueued_at, model_id = req
        # default route/proto ship as None to keep the spec-baggage
        # pickle small (the tuple rides every SUBMIT and EXECUTE frame)
        if route is None:
            route = self._default_route
        if proto is None:
            proto = "python"
        now = time.time()
        queue_wait = now - enqueued_at
        if queue_wait < 0.0:
            # cross-node clock skew hid the wait (enqueued_at is the
            # HANDLE's wall clock): fall back to the skew-free
            # replica-local component — actor-call arrival at this
            # process to execution start. Positive skew inflating the
            # wall measure is undetectable here; keep clocks synced
            # (documented limitation, same tradeoff as the reference's
            # cross-process wall-clock serve metrics).
            recv = _pctx.request_recv_t.get()
            queue_wait = (max(0.0, time.monotonic() - recv)
                          if recv is not None else 0.0)
        telemetry.digest_record(self._wait_digest, queue_wait)
        meta = {"request_id": rid, "deployment": self._deployment,
                "route": route, "proto": proto,
                "enqueued_at": enqueued_at}
        if model_id is not None:
            meta["model_id"] = model_id
        token = _rc.bind(meta)
        parent = tracing.get_current_context()
        traced = parent is not None or tracing.enabled()
        if traced:
            span = tracing.begin_span(
                "request::" + "queue_wait", parent,
                attributes={"request_id": rid,
                            "deployment": self._deployment})
            # the wait ENDED now; it began when the handle enqueued
            span["start_time"] = enqueued_at
            tracing.end_span(span)
        return {"req": meta, "queue_wait": queue_wait, "token": token,
                "traced": traced, "parent": parent,
                "start_wall": now}

    def _exec_span(self, rctx):
        """Only called for TRACED requests (the untraced hot path never
        builds a context manager)."""
        return tracing.start_span(
            "request::" + "replica_execute",
            attributes={"request_id": rctx["req"].get("request_id"),
                        "deployment": self._deployment,
                        "replica": self._replica_tag},
            force=True)

    def _finish_request(self, rctx, t0: float, ok: bool,
                        error=None) -> None:
        if rctx is None:
            return
        token = rctx.pop("token", None)
        if token is not None:
            _rc.unbind(token)
        req = rctx["req"]
        latency = time.monotonic() - t0
        telemetry.digest_record(self._lat_digest, latency)
        row = (time.time(), req.get("request_id"), self._deployment,
               self._replica_tag, req.get("route"), req.get("proto"),
               req.get("model_id"), "ok" if ok else "error", latency,
               rctx["queue_wait"], req.get("batch_size"), error)
        self._request_log.append(row)
        thr = CONFIG._values["serve_slow_request_threshold_s"]
        if not ok or (thr > 0 and latency >= thr):
            self._promote(_shape_row(row), slow=ok)
        # no flush here: the worker's _send_done runs telemetry.
        # maybe_flush AFTER this call's TASK_DONE is on the wire — same
        # shipping cadence, but the (digest-compress + frame) cost
        # lands off the caller's observed latency

    def _promote(self, row: dict, slow: bool) -> None:
        """Relay a slow/error request to the node's EventLogger (the
        literal SLOW_REQUEST/REQUEST_ERROR emit lives node-side — this
        process has no logger)."""
        client = _pctx.current_client
        if client is None:
            return
        what = "slow request" if slow else "request error"
        rec = {
            "kind": "slow" if slow else "error",
            "message": (f"{what} {row.get('request_id')} on "
                        f"{row['deployment']} ({row.get('route')}): "
                        f"latency {row['latency_s']:.3f}s, queue wait "
                        f"{row['queue_wait_s']:.3f}s"
                        + (f" — {row['error']}" if row.get("error")
                           else "")),
            **{k: row.get(k) for k in
               ("request_id", "deployment", "replica", "route",
                "latency_s", "queue_wait_s", "error")},
        }
        try:
            client.send_profile_event("serve_request", rec)
        except Exception:   # noqa: BLE001 — promotion is best-effort
            pass

    def access_log(self, limit: int = 100, slow: bool = False,
                   errors: bool = False):
        """Recent structured request rows from this replica's ring
        (newest last). ``slow`` keeps rows at/over the slow threshold,
        ``errors`` keeps failed rows."""
        # snapshot first: pool threads append concurrently and a deque
        # refuses iteration across a mutation
        rows = [_shape_row(r) for r in list(self._request_log)]
        if errors:
            rows = [r for r in rows if r["status"] == "error"]
        if slow:
            thr = CONFIG.serve_slow_request_threshold_s or 0.0
            rows = [r for r in rows if thr and r["latency_s"] >= thr]
        return rows[-limit:]

    # --------------------------------------------------- request entry
    def handle_request(self, *args, **kwargs):
        # the handle's compact request tuple rides spec.request_ctx and
        # the worker re-binds it around this call — no extra arg slot
        req = _pctx.request_ctx.get()
        self._enter()
        t0 = time.monotonic()
        rctx = self._begin_request(req)
        try:
            if not callable(self._instance):
                raise TypeError("deployment target is not callable")
            if rctx is None or not rctx["traced"]:
                result = self._instance(*args, **kwargs)
            else:
                with self._exec_span(rctx):
                    result = self._instance(*args, **kwargs)
        except BaseException as e:
            self._finish_request(rctx, t0, ok=False, error=repr(e))
            self._exit(t0, ok=False)
            raise
        if inspect.isgenerator(result):
            # streaming: the request is live until the stream drains —
            # record latency/status (and release the queue-depth slot)
            # at exhaustion, not at generator creation. The context
            # token is released here (same thread drives iteration) and
            # re-bound around each step inside the tracker.
            if rctx is not None:
                token = rctx.pop("token", None)
                if token is not None:
                    _rc.unbind(token)
            return self._track_stream(result, t0, rctx)
        self._finish_request(rctx, t0, ok=True)
        self._exit(t0, ok=True)
        return result

    def _track_stream(self, gen, t0: float, rctx=None):
        ok = True
        err = None
        token = _rc.bind(rctx["req"]) if rctx is not None else None
        try:
            yield from gen
        except BaseException as e:
            ok = False
            err = repr(e)
            raise
        finally:
            if token is not None:
                _rc.unbind(token)
            if rctx is not None and rctx.get("traced"):
                # the creation-time replica_execute span closed when
                # the handler RETURNED its generator; the stream's real
                # execution is the drain — emit a stackless span
                # covering it so a traced streaming request's lane
                # shows where the time (and any error) actually went
                span = tracing.begin_span(
                    "request::" + "replica_execute",
                    rctx.get("parent"),
                    attributes={"request_id":
                                rctx["req"].get("request_id"),
                                "deployment": self._deployment,
                                "replica": self._replica_tag,
                                "stream": True})
                span["start_time"] = rctx.get("start_wall",
                                              span["start_time"])
                tracing.end_span(span, error=err)
            self._finish_request(rctx, t0, ok, error=err)
            self._exit(t0, ok)

    def handle_request_mux(self, model_id: str, *args, **kwargs):
        """handle_request with the request's multiplexed model id bound
        for ``serve.get_multiplexed_model_id()`` (reference: proxy sets
        the serve request context's multiplexed_model_id). A streaming
        handler's generator BODY runs lazily during iteration, so the
        binding must wrap the iteration too, not just the call."""
        from .multiplex import (_reset_request_model_id,
                                _set_request_model_id)
        token = _set_request_model_id(model_id)
        try:
            result = self.handle_request(*args, **kwargs)
        finally:
            _reset_request_model_id(token)
        if inspect.isgenerator(result):
            return _iter_with_model_id(model_id, result)
        return result

    def multiplexed_model_ids(self):
        """Model ids currently loaded by any @serve.multiplexed caches
        on this replica (router cache-locality signal)."""
        out = []
        for v in vars(self._instance).values():
            if hasattr(v, "model_ids"):
                try:
                    out.extend(v.model_ids())
                except Exception:   # noqa: BLE001 — introspection only
                    pass
        return out

    def call_method(self, method_name: str, *args, **kwargs):
        self._enter()
        t0 = time.monotonic()
        ok = True
        try:
            return getattr(self._instance, method_name)(*args, **kwargs)
        except BaseException:
            ok = False
            raise
        finally:
            self._exit(t0, ok)

    def queue_depth(self) -> int:
        # executing + queued requests on this replica (approximation of
        # the reference's num_ongoing_requests metric)
        return self._depth

    def reconfigure(self, user_config) -> None:
        if hasattr(self._instance, "reconfigure"):
            self._instance.reconfigure(user_config)


def _iter_with_model_id(model_id: str, gen):
    """Re-bind the request's model id around each step of a streaming
    handler (thread-pooled replicas: per-thread contexts keep this
    isolated between concurrent requests)."""
    from .multiplex import _reset_request_model_id, _set_request_model_id
    token = _set_request_model_id(model_id)
    try:
        yield from gen
    finally:
        _reset_request_model_id(token)
