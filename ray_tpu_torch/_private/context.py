"""Process-global runtime context (driver or worker)."""

from __future__ import annotations

import contextvars
from typing import Any, Optional

# The connected CoreClient for this process (driver after init(), worker
# after registration). Reference analogue: ray._private.worker.global_worker.
current_client: Optional[Any] = None

# Set inside a worker process while executing a task.
current_task_id = None
# Display name of the running task (spec.name): read by the sampling
# profiler's task_filter — best-effort under max_concurrency>1.
current_task_name = None
current_actor_id = None
current_accel_ids = None        # GPU slot indices assigned at dispatch
in_worker: bool = False

# Set by the worker runtime once it hosts an actor instance: the
# callable behind ray_tpu.actor_checkpoint() (captures + persists the
# actor's state now; see WorkerRuntime.checkpoint_now).
actor_checkpoint_hook = None

# Per-task namespace: a ContextVar so concurrent method calls of a
# threaded/async actor each see their own submitter's namespace.
current_namespace: contextvars.ContextVar = contextvars.ContextVar(
    "rtpu_namespace", default=None)

# Request-scoped baggage riding the task spec (reference analogue: W3C
# trace baggage / Serve's request context): a submitter binds a compact
# tuple here and the next submissions carry it in spec.request_ctx —
# INSIDE the one spec pickle stream, not as an extra arg slot (an arg
# slot costs a separate pickle + load per call; the request_ab overhead
# gate prices this path). Workers re-bind it around task execution, so
# the whole nested call tree of one serve request shares the baggage.
request_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "rtpu_request_ctx", default=None)

# Monotonic receive stamp of the actor call carrying request baggage
# (set by the worker beside request_ctx, only for requests): the
# replica's skew-free fallback for queue-wait when cross-node wall
# clocks disagree (enqueued_at comes from the HANDLE's clock).
request_recv_t: contextvars.ContextVar = contextvars.ContextVar(
    "rtpu_request_recv_t", default=None)


def active_namespace() -> str:
    ns = current_namespace.get()
    if ns is not None:
        return ns
    return current_client.namespace if current_client else "default"


def require_client():
    if current_client is None:
        raise RuntimeError(
            "ray_tpu is not initialized; call ray_tpu.init() first")
    return current_client
