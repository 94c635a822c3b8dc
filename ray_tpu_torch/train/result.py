"""Result of a training run (reference: ``air/result.py``); a copy of
``ray_tpu/train/result.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: Optional[str]
    error: Optional[Exception] = None
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        return self.checkpoint
