"""Trainer configuration dataclasses.

Counterpart of ``ray_tpu/train/config.py``. Reference: ``python/ray/air/
config.py:94`` (ScalingConfig), ``:723`` (RunConfig), ``:523``
(FailureConfig), ``:574`` (CheckpointConfig). ``ScalingConfig.mesh`` is
the port's `MeshSpec`: the mesh the gang's process group is cut into.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Optional

if TYPE_CHECKING:   # the parallel package imports torch; the trainer's
    from ..parallel.mesh import MeshSpec   # driver side never needs it


@dataclasses.dataclass
class ScalingConfig:
    """How many workers, what resources each, what device mesh.

    num_workers: one per card (a worker with a GPU slot owns its card on
    the port's runtime; JAX's trainer runs one per TPU host). ``use_gpu``
    gives each worker's bundle one GPU, where ``use_tpu`` gives a host's
    four TPU chips. Like every entry point of the port it is on by
    default; ``use_gpu=False`` makes the workers plain CPU actors.
    """

    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "STRICT_SPREAD"
    mesh: Optional[MeshSpec] = None

    def bundle(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res.setdefault("GPU", 1.0)     # one card per worker
        return res


@dataclasses.dataclass
class FailureConfig:
    """max_failures: worker-gang restarts before giving up; -1 = infinite."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_frequency: int = 0


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    verbose: int = 0
