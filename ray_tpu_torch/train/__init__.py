"""ray_tpu_torch.train — distributed training orchestration on the port's
runtime.

Counterpart of ``ray_tpu/train/`` (reference: Ray Train,
``python/ray/train/``, SURVEY §2.3/§3.4). `TorchTrainer` gangs one worker
actor per card (``ScalingConfig(use_gpu=True)``: one GPU slot each) or per
CPU worker, joins them in one `torch.distributed` process group (NCCL on
cards, gloo on the CPU) and runs the user's ``train_loop_per_worker`` in
lockstep on every worker; the loop cuts the group into a mesh with
``parallel.build_mesh(ScalingConfig.mesh)``. Checkpoints hold torch state
dicts, sharded ones through ``torch.distributed.checkpoint``.
"""

from .checkpoint import Checkpoint  # noqa: F401
from .config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from .result import Result  # noqa: F401
from .session import (  # noqa: F401
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from .trainer import TorchTrainer  # noqa: F401
