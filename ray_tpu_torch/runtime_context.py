"""Runtime context introspection (reference:
``python/ray/runtime_context.py`` — get_runtime_context)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ._private import context


@dataclass
class RuntimeContext:
    job_id: object
    worker_id: object
    node_id: Optional[object]
    task_id: Optional[object]
    actor_id: Optional[object]
    in_worker: bool
    accel_ids: Optional[list] = None

    def get_accelerator_ids(self) -> dict:
        """Per-instance GPU slots assigned to this task/actor (reference:
        ``RuntimeContext.get_accelerator_ids``); the worker's
        ``CUDA_VISIBLE_DEVICES`` names the same cards. Empty on the driver
        or for fractional/zero demands."""
        return {"GPU": list(self.accel_ids or [])}

    def get_job_id(self):
        return self.job_id

    def get_worker_id(self):
        return self.worker_id

    def get_node_id(self):
        return self.node_id

    def get_task_id(self):
        return self.task_id

    def get_actor_id(self):
        return self.actor_id


def get_runtime_context() -> RuntimeContext:
    client = context.require_client()
    return RuntimeContext(
        job_id=client.job_id,
        worker_id=client.worker_id,
        node_id=getattr(client, "node_id", None),
        task_id=context.current_task_id,
        actor_id=context.current_actor_id,
        in_worker=context.in_worker,
        accel_ids=context.current_accel_ids,
    )
