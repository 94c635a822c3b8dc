"""User-facing exceptions.

Mirrors the semantic set of the reference's ``python/ray/exceptions.py``:
task errors that wrap remote tracebacks, actor death, object loss, and
cancellation — the names are our own.
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised an exception.

    Re-raised at ``get()`` on the caller, carrying the remote traceback as
    text (reference analogue: ``RayTaskError``,
    ``python/ray/exceptions.py``).
    """

    def __init__(self, cause_cls_name: str, cause_msg: str, traceback_str: str,
                 task_name: str = ""):
        self.cause_cls_name = cause_cls_name
        self.cause_msg = cause_msg
        self.traceback_str = traceback_str
        self.task_name = task_name
        super().__init__(self._format())

    def _format(self) -> str:
        return (
            f"task {self.task_name or '<unknown>'} failed with "
            f"{self.cause_cls_name}: {self.cause_msg}\n"
            f"--- remote traceback ---\n{self.traceback_str}"
        )

    def __reduce__(self):
        return (TaskError, (self.cause_cls_name, self.cause_msg,
                            self.traceback_str, self.task_name))


class ActorError(RayTpuError):
    """An actor task cannot run because the actor is dead or dying."""


class ActorDiedError(ActorError):
    def __init__(self, actor_id, reason: str = ""):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"actor {actor_id} died: {reason}")

    def __reduce__(self):
        return (ActorDiedError, (self.actor_id, self.reason))


class ObjectLostError(RayTpuError):
    """An object's value was lost from the store and cannot be recovered."""

    def __init__(self, object_id, reason: str = ""):
        self.object_id = object_id
        super().__init__(f"object {object_id} lost: {reason}")

    def __reduce__(self):
        return (ObjectLostError, (self.object_id,))


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"task {task_id} was cancelled")

    def __reduce__(self):
        return (TaskCancelledError, (self.task_id,))


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get()`` timed out before the object was available."""


class WorkerCrashedError(RayTpuError):
    """The worker process executing a task died unexpectedly."""


class OutOfMemoryError(WorkerCrashedError):
    """The memory monitor killed the worker to relieve node memory
    pressure (reference analogue: ``ray.exceptions.OutOfMemoryError``)."""


class RuntimeEnvSetupError(RayTpuError):
    """Setting up the runtime environment for a task/actor failed."""


class PendingCallsLimitExceededError(RayTpuError):
    """Too many in-flight calls to an actor with a bounded queue."""
