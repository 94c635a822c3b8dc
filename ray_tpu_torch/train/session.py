"""Per-worker training session (reference: ``train/_internal/session.py``
— ``_TrainSession.report`` :612; user API ``ray.train.report`` /
``get_context()``). A copy of ``ray_tpu/train/session.py``, with the
worker's rank on its node and the directory its gang shares for a sharded
checkpoint.

Workers call ``report(metrics, checkpoint=...)`` each epoch/interval;
results stream back to the trainer through a driver-owned results queue.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

from .checkpoint import Checkpoint

_session_local = threading.local()


class TrainContext:
    def __init__(self, world_rank: int, world_size: int,
                 results_queue, latest_checkpoint: Optional[Checkpoint],
                 config: Optional[Dict[str, Any]] = None,
                 storage_path: Optional[str] = None,
                 experiment_name: str = "train",
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 local_rank: Optional[int] = None,
                 attempt: int = 0):
        self.world_rank = world_rank
        self.world_size = world_size
        self.results_queue = results_queue
        self.latest_checkpoint = latest_checkpoint
        self.config = config or {}
        self.storage_path = storage_path
        self.experiment_name = experiment_name
        self.dataset_shards = dataset_shards or {}
        self.local_rank = world_rank if local_rank is None else local_rank
        self.attempt = attempt
        self.iteration = 0

    def get_dataset_shard(self, name: str = "train"):
        """This worker's streaming shard of the trainer's ``datasets``
        (reference: ``ray.train.get_dataset_shard``)."""
        try:
            return self.dataset_shards[name]
        except KeyError:
            raise KeyError(
                f"no dataset {name!r} was passed to TorchTrainer(datasets="
                f"...); have {sorted(self.dataset_shards)}") from None

    # reference: ray.train.get_context() surface
    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        """This worker's rank among the gang's workers on its node."""
        return self.local_rank

    def get_trial_name(self) -> str:
        return self.experiment_name

    def shared_checkpoint_dir(self) -> str:
        """The directory every rank writes its shards of the next reported
        checkpoint into: the same path on every rank (the ranks report in
        step), new for each report and each attempt, under the experiment
        directory."""
        return os.path.join(self.storage_path or ".", self.experiment_name,
                            ".staging",
                            f"attempt{self.attempt}_report{self.iteration + 1}")


def _set_session(ctx: Optional[TrainContext]) -> None:
    _session_local.ctx = ctx


def _current() -> Optional[TrainContext]:
    return getattr(_session_local, "ctx", None)


def get_context() -> TrainContext:
    ctx = _current()
    if ctx is None:
        raise RuntimeError(
            "not inside a train session (call from train_loop_per_worker)")
    return ctx


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) for this iteration.

    Rank 0's checkpoint is persisted; other ranks' checkpoints are
    ignored. A sharded checkpoint (`Checkpoint.from_state_dict` of
    DTensors) is one directory that every rank has written its shards
    into before rank 0's save returned, so rank 0's path holds them all.
    """
    ctx = get_context()
    ctx.iteration += 1
    payload = {
        "rank": ctx.world_rank,
        "iteration": ctx.iteration,
        "metrics": dict(metrics),
        "checkpoint_path": None,
    }
    if checkpoint is not None and ctx.world_rank == 0:
        checkpoint.set_metrics(metrics)
        payload["checkpoint_path"] = checkpoint.path
        ctx.latest_checkpoint = checkpoint
    ctx.results_queue.put(payload)


def get_checkpoint() -> Optional[Checkpoint]:
    """Latest checkpoint to resume from (set on restart after failure)."""
    return get_context().latest_checkpoint


def get_dataset_shard(name: str = "train"):
    """Module-level convenience (reference: ``ray.train.get_dataset_shard``)."""
    return get_context().get_dataset_shard(name)
