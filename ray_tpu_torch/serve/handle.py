"""DeploymentHandle — client-side router with power-of-two-choices.

Reference: ``serve/_private/router.py:944`` (Router) + ``:330``
(PowerOfTwoChoicesReplicaScheduler): pick two random replicas, send to
the one with the shorter queue. Queue lengths here are tracked
client-side per handle (in-flight counter per replica), refreshed with
the controller's replica list on a TTL.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Optional

from .. import get
from .._private import context as _pctx
from .._private import locksan
from . import request_context as _rc

_REFRESH_S = 1.0


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller):
        self.deployment_name = deployment_name
        self._default_route = f"/{deployment_name}"
        self._controller = controller
        self._replicas: List[Any] = []
        self._inflight: Dict[int, int] = {}
        # multiplexing cache locality: model_id -> replica index that
        # loaded it last (reference: router prefers replicas whose
        # multiplexed-model cache holds the request's model)
        self._model_affinity: Dict[str, int] = {}
        self._last_refresh = 0.0
        self._lock = locksan.lock("serve.handle")
        self._rng = random.Random()

    # -------------------------------------------------------------- routing
    def _refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_refresh < _REFRESH_S:
            return
        replicas = get(self._controller.get_replicas.remote(
            self.deployment_name))
        def ids(rs):
            return [getattr(r, "_actor_id", None) for r in rs]

        with self._lock:
            if ids(replicas) != ids(self._replicas):
                # the replica SET changed (stable actor ids — fresh
                # handle objects deserialize per poll): indices shifted,
                # cached model->replica affinities point at the wrong
                # replicas now
                self._model_affinity.clear()
            self._replicas = replicas
            self._inflight = {i: self._inflight.get(i, 0)
                              for i in range(len(replicas))}
            self._last_refresh = now

    def _pick(self) -> int:
        with self._lock:
            n = len(self._replicas)
            if n == 0:
                raise RuntimeError(
                    f"deployment {self.deployment_name!r} has no replicas")
            if n == 1:
                idx = 0
            else:
                a, b = self._rng.sample(range(n), 2)
                idx = a if self._inflight.get(a, 0) <= \
                    self._inflight.get(b, 0) else b
            self._inflight[idx] = self._inflight.get(idx, 0) + 1
            return idx

    def _done(self, idx: int) -> None:
        with self._lock:
            if idx in self._inflight and self._inflight[idx] > 0:
                self._inflight[idx] -= 1

    def _pick_for_model(self, model_id: str) -> int:
        """Prefer the replica that already holds this model (LRU cache
        locality); fall back to power-of-two and remember the choice."""
        with self._lock:
            idx = self._model_affinity.get(model_id)
            if idx is not None and idx < len(self._replicas):
                self._inflight[idx] = self._inflight.get(idx, 0) + 1
                return idx
        idx = self._pick()
        with self._lock:
            if len(self._model_affinity) >= 256:
                self._model_affinity.pop(
                    next(iter(self._model_affinity)))
            self._model_affinity[model_id] = idx
        return idx

    def options(self, *, multiplexed_model_id: Optional[str] = None
                ) -> "DeploymentHandle":
        """Per-request routing options (reference:
        ``handle.options(multiplexed_model_id=...)``)."""
        if multiplexed_model_id is None:
            return self
        return _ModelBoundHandle(self, multiplexed_model_id)

    # ---------------------------------------------------------------- calls
    def remote(self, *args, **kwargs):
        """Route one request; returns an ObjectRef."""
        return self._route(None, *args, **kwargs)

    def _request_meta(self, model_id) -> Optional[tuple]:
        """Request metadata shipped to the replica in
        ``spec.request_ctx``: the ingress context when one is bound
        (HTTP/gRPC gateways), a fresh one otherwise (plain Python
        callers) — every request gets an id. ``enqueued_at`` is stamped
        HERE so the replica's queue-wait measurement covers routing +
        actor-call queueing. A compact TUPLE riding INSIDE the one spec
        pickle stream — NOT an extra arg slot, which costs a separate
        pickle + load per call (the request_ab overhead gate prices
        this path)."""
        if not _rc.enabled():
            return None
        ctx = _rc.current()
        if ctx is not None:
            # default route/proto ship as None (replica reconstructs):
            # the tuple is pickled on every SUBMIT and EXECUTE frame
            route = ctx.get("route")
            if route == self._default_route:
                route = None
            proto = ctx.get("proto", "python")
            return (ctx.get("request_id") or _rc.new_request_id(),
                    route,
                    None if proto == "python" else proto,
                    time.time(), model_id)
        return (_rc.new_request_id(), None, None, time.time(), model_id)

    def _route(self, model_id, *args, **kwargs):
        self._refresh()
        meta = self._request_meta(model_id)
        token = (_pctx.request_ctx.set(meta)
                 if meta is not None else None)
        try:
            for attempt in range(3):
                idx = (self._pick() if model_id is None
                       else self._pick_for_model(model_id))
                with self._lock:
                    replica = self._replicas[idx]
                try:
                    if model_id is None:
                        ref = replica.handle_request.remote(*args,
                                                            **kwargs)
                    else:
                        ref = replica.handle_request_mux.remote(
                            model_id, *args, **kwargs)
                except Exception:
                    self._done(idx)
                    with self._lock:
                        if self._model_affinity.get(model_id) == idx:
                            del self._model_affinity[model_id]
                    self._refresh(force=True)
                    continue
                # in-flight slot released when the response is consumed
                return _TrackedRef(ref, self, idx)
            raise RuntimeError("no live replica accepted the request")
        finally:
            if token is not None:
                _pctx.request_ctx.reset(token)

    def stream(self, *args, **kwargs):
        """Route one STREAMING request: the deployment's handler must
        return a generator, whose items arrive as they are produced
        (reference: Serve streaming responses over ObjectRefGenerator).
        Returns an iterator of item VALUES."""
        return self._route_stream(None, *args, **kwargs)

    def _route_stream(self, model_id, *args, **kwargs):
        self._refresh()
        meta = self._request_meta(model_id)
        token = (_pctx.request_ctx.set(meta)
                 if meta is not None else None)
        try:
            for attempt in range(3):
                idx = (self._pick() if model_id is None
                       else self._pick_for_model(model_id))
                with self._lock:
                    replica = self._replicas[idx]
                try:
                    if model_id is None:
                        gen = replica.handle_request.options(
                            num_returns="streaming").remote(*args,
                                                            **kwargs)
                    else:
                        gen = replica.handle_request_mux.options(
                            num_returns="streaming").remote(
                                model_id, *args, **kwargs)
                except Exception:
                    self._done(idx)
                    with self._lock:
                        if self._model_affinity.get(model_id) == idx:
                            del self._model_affinity[model_id]
                    self._refresh(force=True)
                    continue
                return _TrackedStream(gen, self, idx)
            raise RuntimeError("no live replica accepted the request")
        finally:
            if token is not None:
                _pctx.request_ctx.reset(token)

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name, self._controller))


class _ModelBoundHandle:
    """A DeploymentHandle view with a fixed multiplexed model id."""

    def __init__(self, handle: DeploymentHandle, model_id: str):
        self._handle = handle
        self._model_id = model_id

    def remote(self, *args, **kwargs):
        return self._handle._route(self._model_id, *args, **kwargs)

    def stream(self, *args, **kwargs):
        return self._handle._route_stream(self._model_id,
                                          *args, **kwargs)

    def options(self, *, multiplexed_model_id: Optional[str] = None):
        if multiplexed_model_id is None:
            return self
        return _ModelBoundHandle(self._handle, multiplexed_model_id)

    def __getattr__(self, name):
        return getattr(self._handle, name)


class _TrackedStream:
    """Iterates a streaming response's values; releases the replica's
    in-flight slot when the stream ends (or is dropped)."""

    def __init__(self, gen, handle: "DeploymentHandle", idx: int):
        self._gen = gen
        self._handle = handle
        self._idx = idx
        self._released = False

    def __iter__(self):
        return self

    def __next__(self):
        try:
            ref = next(self._gen)
        except BaseException:
            self._release()
            raise
        return get(ref)

    def _release(self) -> None:
        if not self._released:
            self._released = True
            self._handle._done(self._idx)

    def __del__(self):
        self._release()


class _TrackedRef:
    """ObjectRef wrapper that releases the in-flight slot on result()."""

    def __init__(self, ref, handle: DeploymentHandle, idx: int):
        self._ref = ref
        self._handle = handle
        self._idx = idx
        self._resolved = False

    @property
    def ref(self):
        return self._ref

    def result(self, timeout: Optional[float] = None):
        try:
            return get(self._ref, timeout=timeout)
        finally:
            if not self._resolved:
                self._resolved = True
                self._handle._done(self._idx)
